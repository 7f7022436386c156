"""One train step of the Mamba and MoE ids (``mamba2-130m``,
``mixtral-8x22b``, ``jamba-v0.1-52b``, ``kimi-k2-1t-a32b``), ``reduced()``,
against ``jax.grad`` of the reference's ``loss_fn``, as
``tests/test_torch_train_dense.py`` does the rest of the zoo (its helper,
its tolerances).

On the CPU the Mamba layers differentiate through the sequential SSD
(``ops.ssd_auto``); on the card K4 has no backward yet (ROADMAP §A item
13). The MoE's capacity drops depend on the batch: at these inputs (2 x
16 tokens, 4 experts top-2) the routers agree on every token
(``tests/test_torch_moe.py`` checks the router margins), so the two sides
drop the same pairs and their gradients, the router's included, compare.
"""

import pytest

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402
from test_torch_train_dense import check_train_step  # noqa: E402

IDS = ["mamba2-130m", "mixtral-8x22b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.mark.parametrize("arch", IDS)
def test_train_step_matches_reference(ref, arch):
    grads = check_train_step(ref, arch)
    routers = [k for k in grads if k.endswith("mlp.router.w")]
    assert bool(routers) == (arch != "mamba2-130m")
    for k in routers:      # the router learns through the kept weights
        assert float(grads[k].abs().sum()) > 0, k
