"""``ModelConfig.remat_layers`` in the port: refused, naming ROADMAP item
11, at every entry that builds a model (``check_config``,
``init_params``, ``convert.lm_params_from_jax``); the default ``False``
still builds, from the port's own init and from the reference's
parameters.

The reference honours the flag with ``jax.checkpoint`` per layer. The
port takes its gradients with ``torch.func.grad`` over
``functional_call``, and ``torch.utils.checkpoint`` does not compose with
it in either mode, so the port refuses the flag rather than keep every
activation while the caller believes them dropped.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import model as M

# one id of each mixer family: Mamba, dense attention, the hybrid MoE
IDS = ["mamba2-130m", "yi-6b", "jamba-v0.1-52b"]


def remat(name):
    return dataclasses.replace(configs.get_config(name).reduced(),
                               remat_layers=True)


@pytest.mark.parametrize("entry", ["check_config", "init_params",
                                   "lm_params_from_jax"])
@pytest.mark.parametrize("arch", IDS)
def test_remat_layers_is_refused(arch, entry):
    cfg = remat(arch)
    call = {"check_config": lambda: M.check_config(cfg),
            "init_params": lambda: M.init_params(
                torch.Generator().manual_seed(0), cfg, device="cpu"),
            "lm_params_from_jax": lambda: lm_params_from_jax(
                {}, cfg, device="cpu")}[entry]
    with pytest.raises(NotImplementedError, match="item 11") as info:
        call()
    assert "torch.func.grad" in str(info.value)


@pytest.mark.parametrize("arch", IDS)
def test_remat_layers_off_still_builds(arch):
    """The default builds from the port's init and from the reference's
    parameters, leaf for leaf the same names and shapes."""
    pytest.importorskip("jax")
    from test_torch_reference import reference
    ref = reference()
    cfg = configs.get_config(arch).reduced()
    assert cfg.remat_layers is False
    M.check_config(cfg)
    own = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rparams = ref.model.init_params(ref.jax.random.PRNGKey(0),
                                    ref.configs.get_config(arch).reduced())
    carried = lm_params_from_jax(ref.jax.tree.map(np.asarray, rparams), cfg,
                                 device="cpu")
    shapes = {k: tuple(v.shape) for k, v in own.named_parameters()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in carried.named_parameters()}
