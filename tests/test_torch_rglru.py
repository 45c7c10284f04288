"""Port parity for the Griffin / RecurrentGemma recurrent block and the
RG-LRU + local-attention config (recurrentgemma-9b smoke: 1 block of
(rglru, rglru, attn_local) + 2 remainder layers, window 8), f32, on the
reference's weights.

`conv1d_causal` (full sequence and the decode window) and the RG-LRU block
against the reference's: the port scans in log depth where the reference's
`associative_scan` combines in another order, so the block's output agrees
within 1e-5 (f32 rounding of a recurrence over ≤ 40 steps), and the
port's decode chain reproduces its own scan within the same bound. The
config's serving loop against the reference's engine, and a chaos
schedule whose faults hit after a step has advanced the recurrent state:
statuses, tokens, checks and counters equal the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import layers as jlayers
from repro.models import rglru as jrg
from repro_torch import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trg
from test_torch_archs_serve import _cases, _check_chaos, _check_routing_and_generate, _check_serve

ARCH = "recurrentgemma-9b"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """(reference cfg, reference block params, port cfg, port block params)."""
    jcfg = dataclasses.replace(j_get_smoke_config(ARCH), dtype="float32")
    jp = jrg.init_rglru(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, bridge.config_from_reference(jcfg), bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp))


def _x(cfg, b, s, seed=4):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def test_conv1d_causal_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 6)).astype(np.float32)
    yj, _ = jlayers.conv1d_causal(jnp.asarray(x), jnp.asarray(w))
    yt, none = tlayers.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w))
    assert none is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    yj, cj = jlayers.conv1d_causal(jnp.asarray(x[:, :1]), jnp.asarray(w), jnp.asarray(cache))
    yt, ct = tlayers.conv1d_causal(torch.from_numpy(x[:, :1]), torch.from_numpy(w),
                                   torch.from_numpy(cache))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))  # the window shifts exactly


def test_apply_rglru_matches_reference(block):
    jcfg, jp, tcfg, tp = block
    x = _x(jcfg, 2, 37)
    yj = jrg.apply_rglru(jp, jnp.asarray(x), jcfg)
    yt = trg.apply_rglru(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)


def test_decode_chain_matches_scan_and_reference(block):
    """Step by step from a zeroed cache: each output against the reference's
    decode step (and the state after it), and the chain against the port's
    own full-sequence scan."""
    jcfg, jp, tcfg, tp = block
    x = _x(jcfg, 2, 21)
    full = trg.apply_rglru(tp, torch.from_numpy(x), tcfg)
    jc = jrg.init_rglru_cache(2, jcfg)
    tc = trg.init_rglru_cache(2, tcfg)
    for t in range(x.shape[1]):
        yj, jc = jrg.decode_rglru(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        yt = trg.decode_rglru(tp, torch.from_numpy(x[:, t:t + 1]), tc, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
        np.testing.assert_allclose(yt.numpy(), full[:, t:t + 1].numpy(), rtol=0, atol=TOL)
    for key in ("lru_state", "conv_cache"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), rtol=0, atol=TOL)


@pytest.mark.parametrize("arch, loop", _cases((ARCH,)))
def test_serve_matches_reference(arch, loop):
    _check_serve(arch, loop)


def test_routing_and_generate_match_reference():
    _check_routing_and_generate(ARCH)


def test_chaos_after_a_state_update_matches_reference():
    """lru_state, conv_cache and the window ring advanced by a faulted step
    come back before the retry."""
    _check_chaos(ARCH, "contiguous")
