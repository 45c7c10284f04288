"""Port parity: the serving engine on the MoE configs (llama4-scout-17b-a16e,
qwen3-moe-235b-a22b) at smoke width, f32, on the reference's weights,
against the reference `Engine`: greedy tokens identical on every loop the
reference runs for each (llama4: contiguous and paged, its chunked layers'
rings beside the NoPE layer's pages; qwen3-moe: all three), routing and
`generate` — the helpers of `test_torch_archs_serve.py`. MoE capacity is
shared by every row of a step, dead slots and padding rows included, so
equal tokens also pin what the port stages there."""

import pytest
import torch

from test_torch_archs_serve import _cases, _check_routing_and_generate, _check_serve

ARCHS = ("llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch, loop", _cases(ARCHS))
def test_serve_matches_reference(arch, loop):
    _check_serve(arch, loop)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_generate_match_reference(arch):
    _check_routing_and_generate(arch)
