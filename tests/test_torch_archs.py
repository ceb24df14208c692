"""The reduced configs of mistral-nemo-12b (dense, silu), nemotron-4-15b
(dense, the ``sqrelu`` MLP: relu(x W_up)^2 W_down) and moonshot-v1-16b-a3b
(MoE) in the port against the JAX package, f32, CPU, on the JAX init
carried across by ``interop.params_from_numpy``: ``forward``'s hidden
states and one decode step (hidden state and every state leaf) within
1e-5 relative to max(1, max |h|), as ``test_torch_gemma3.py`` holds its
family."""
import numpy as np
import pytest

import _torch_families as F

TOL = 1e-5


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "nemotron-4-15b",
                                  "moonshot-v1-16b-a3b"])
def test_forward_and_decode_step_equal_jax(arch):
    m = F.build(arch)
    if arch == "nemotron-4-15b":
        assert m["tcfg"].act == "sqrelu" and "gate" not in \
            m["tp"]["blocks"]["ffn"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, m["tcfg"].vocab, (2, 12))
    assert F.forward_err(m, toks) <= TOL
    h_err, leaf_err = F.decode_errs(m, toks[:, :1], max_len=4)
    assert h_err <= TOL
    assert leaf_err and max(leaf_err.values()) <= TOL, leaf_err
