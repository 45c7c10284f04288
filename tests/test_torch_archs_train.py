"""Port parity: one train step of the reference's dense-GQA, MoE +
chunked-attention, RG-LRU + local-attention, Mamba-2 and vision-stub
configs (deepseek-7b, qwen2-1.5b, yi-34b, llama4-scout-17b-a16e,
qwen3-moe-235b-a22b, recurrentgemma-9b, mamba2-2.7b, phi-3-vision-4.2b;
text batches: phi-3's patch rows in `test_torch_phi3v.py`) at smoke width, f32, on the reference's weights and
the same `SyntheticLM` batch: the loss (ce + the MoE aux and z losses), ce
and the grad norm within 1e-4 relative (summation order only; the
gradients of the MoE router pass through a discrete top-k, which both
packages take alike), the three MoE aux values within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import get_model as j_get_model
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.models.moe import AUX_KEYS
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts

ARCHS = ("deepseek-7b", "qwen2-1.5b", "yi-34b", "llama4-scout-17b-a16e",
         "qwen3-moe-235b-a22b", "recurrentgemma-9b", "mamba2-2.7b", "phi-3-vision-4.2b")
REL = 1e-4
AUX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype="float32")
    tcfg = bridge.config_from_reference(jcfg)
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    ttc = tts.TrainConfig(optimizer=tadamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)._replace(params=jp)
    tstate = tts.init_train_state(
        tcfg, ttc, params=bridge.params_from_numpy(jax.tree.map(np.asarray, jp)))
    batch = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=24,
                                     global_batch=2)).batch(0)
    _, jm = jax.jit(jts.make_train_step(jcfg, jtc))(jstate, jax.tree.map(jnp.asarray, batch))
    _, tm = tts.make_train_step(tcfg, ttc)(tstate, {k: torch.from_numpy(x)
                                                    for k, x in batch.items()})
    assert sorted(tm) == sorted(jm)
    for key in ("loss", "ce", "grad_norm"):
        assert abs(float(jm[key]) - float(tm[key])) <= REL * abs(float(jm[key])), key
    for key in AUX_KEYS:
        assert abs(float(jm[key]) - float(tm[key])) <= AUX_TOL, key
    assert (float(tm["moe_aux_loss"]) > 0) == (jcfg.n_experts > 0)
