"""Port parity for the Mamba-2 SSD block and the attention-free config
(mamba2-2.7b smoke: 2 `ssm` layers, d_model 64, 8 heads of 16, state 16,
chunk 8), f32, on the reference's weights.

`_segsum`, `ssd_chunked` and `apply_mamba2` against the reference's: the
same chunked algorithm in another contraction order, so within 1e-5; S a
multiple of the chunk and S not one (the pad to the chunk and the slice
back), at two chunk sizes. The port's decode chain reproduces its own
chunked block and the reference's decode steps within the same bound.
A stack with no global-attention layer takes no pool: a paged or mixed
engine serves it on the contiguous loop, as the reference's does, with no
speculation; tokens, routing, `generate` and a chaos schedule whose faults
hit after a step has advanced the SSM state equal the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import mamba2 as jm2
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.models import mamba2 as tm2
from repro_torch.serve import Engine, ServeConfig
from test_torch_archs_serve import LOOPS, _check_chaos, _check_routing_and_generate, \
    _check_serve, _model

ARCH = "mamba2-2.7b"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(chunk: int):
    """(reference cfg, reference block params, port cfg, port block params)."""
    jcfg = dataclasses.replace(j_get_smoke_config(ARCH), dtype="float32", ssm_chunk=chunk)
    jp = jm2.init_mamba2(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, bridge.config_from_reference(jcfg), bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp))


def _x(cfg, b, s, seed=4):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def test_segsum_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 3, 7)).astype(np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(x)))
    got = tm2._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk", [8, 4])
def test_ssd_chunked_matches_reference(chunk):
    """The SSD on its own, S 24 (3 or 6 chunks, the inter-chunk carry); a
    ragged S raises in both packages."""
    rng = np.random.default_rng(6)
    b, s, h, p, n = 2, 24, 3, 5, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    d_skip = rng.standard_normal((h,)).astype(np.float32)
    args = (x, dt, a_log, bm, cm, d_skip)
    want = jm2.ssd_chunked(*map(jnp.asarray, args), chunk)
    got = tm2.ssd_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    ragged = (x[:, :s - 3], dt[:, :s - 3], a_log, bm[:, :s - 3], cm[:, :s - 3], d_skip)
    with pytest.raises(Exception):
        jm2.ssd_chunked(*map(jnp.asarray, ragged), chunk)
    with pytest.raises(RuntimeError):
        tm2.ssd_chunked(*map(torch.from_numpy, ragged), chunk)


@pytest.mark.parametrize("chunk", [8, 4])
@pytest.mark.parametrize("s", [24, 21])
def test_apply_mamba2_matches_reference(chunk, s):
    """S a multiple of the chunk, and S 21 (padded to the chunk, cut back)."""
    jcfg, jp, tcfg, tp = _block(chunk)
    x = _x(jcfg, 2, s)
    yj = jm2.apply_mamba2(jp, jnp.asarray(x), jcfg)
    yt = tm2.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    assert yt.shape == (2, s, jcfg.d_model)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)


def test_decode_chain_matches_chunked_and_reference():
    """Step by step from a zeroed cache over 19 positions (past two chunk
    boundaries): each output against the reference's decode step and the
    port's own chunked block, then the state and conv window against the
    reference's; the cache advances in place (the tensors the caller holds)."""
    jcfg, jp, tcfg, tp = _block(8)
    x = _x(jcfg, 2, 19)
    full = tm2.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    jc = jm2.init_mamba2_cache(2, jcfg)
    tc = tm2.init_mamba2_cache(2, tcfg)
    held = dict(tc)
    assert tc["ssm_state"].shape == (2, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
    assert tc["ssm_state"].dtype == torch.float32
    for t in range(x.shape[1]):
        yj, jc = jm2.decode_mamba2(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        yt = tm2.decode_mamba2(tp, torch.from_numpy(x[:, t:t + 1]), tc, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
        np.testing.assert_allclose(yt.numpy(), full[:, t:t + 1].numpy(), rtol=0, atol=TOL)
    for key in ("ssm_state", "conv_cache"):
        assert tc[key] is held[key]
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), rtol=0, atol=TOL)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_serve_matches_reference(loop):
    """Every loop setting: the paged and mixed engines serve on the
    contiguous loop, as the reference's do."""
    _check_serve(ARCH, loop)


def test_routing_and_generate_match_reference():
    _check_routing_and_generate(ARCH)
    _, _, tcfg, tp = _model(ARCH)
    for kw in LOOPS.values():
        te = Engine(tp, tcfg, ServeConfig(max_len=32, **kw), device="cpu")
        assert te._page_layout is None and not te._mixed_ok and not te._cache_on


def test_speculation_is_refused_as_the_reference():
    """No pool, no packed step: speculation raises in both packages."""
    jcfg, jp, tcfg, tp = _model(ARCH)
    kw = dict(max_len=32, kv_layout="paged", spec_tokens=2)
    with pytest.raises(ValueError, match="packed"):
        JEngine(jp, jcfg, JServeConfig(**kw), draft=lambda *a: None)
    with pytest.raises(ValueError, match="packed"):
        Engine(tp, tcfg, ServeConfig(**kw), device="cpu", draft=lambda *a: None)


def test_chaos_after_a_state_update_matches_reference():
    """ssm_state and conv_cache advanced by a faulted step come back before
    the retry."""
    _check_chaos(ARCH, "contiguous")
