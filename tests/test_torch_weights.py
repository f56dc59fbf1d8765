"""fasterseg_tpu_torch weights: the JAX package's variables through
`from_jax_variables` into the port's DerivedNet, against the JAX DerivedNet
on the CPU, fp32.

The same seeded variables (the JAX `create_derived` init plus one train-mode
step, so the BN running statistics are non-trivial) go through both
packages. `_both` is shared with tests/test_torch_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterseg_tpu.core.genotype import Genotype, path_to_downs
from fasterseg_tpu.core.plan import build_plan
from fasterseg_tpu.models import create_derived
from fasterseg_tpu.models import student_plan as jax_student_plan
import fasterseg_tpu_torch.core as tcore
import fasterseg_tpu_torch.models as tmodels
from fasterseg_tpu_torch.models import DerivedNet
from fasterseg_tpu_torch.utils import from_jax_variables, load_reference_state_dict

HW = (64, 128)


def _geno(core, ops, path):
    return core.Genotype(ops=tuple(ops), path=tuple(path),
                         downs=tuple(path_to_downs(path)),
                         widths=tuple([1.0] * (len(path) - 1)))


def _synthetic_plan(core):
    """lasts=(2,1): skip at stride 1 and 2 (FactorizedReduce), conv (op1) at
    both strides and conv_2x down (op3). As in tests/test_fast_body.py."""
    g2 = _geno(core, (1, 0, 0, 1), (0, 0, 1, 2))
    g1 = _geno(core, (0, 3, 1), (0, 0, 1))
    return core.build_plan({2: g2, 1: g1}, [2, 1], Fch=8, num_classes=7,
                           stem_head_width=(1.0, 1.0))


def _passthrough_plan(core):
    """lasts=(1,0): the last==0 aggregation passthrough and a zoomed
    stride-2 (op4 down) + zoomed stride-1 (op2) mix."""
    g1 = _geno(core, (4, 2, 1), (0, 1, 1))
    g0 = _geno(core, (2, 1, 1), (0, 0, 0))
    return core.build_plan({1: g1, 0: g0}, [1, 0], Fch=8, num_classes=5,
                           stem_head_width=(1.0, 1.0))


class _JaxCore:
    Genotype = Genotype
    build_plan = staticmethod(build_plan)


PLANS = {
    "student": (lambda: jax_student_plan(), lambda: tmodels.student_plan()),
    "synthetic": (lambda: _synthetic_plan(_JaxCore),
                  lambda: _synthetic_plan(tcore)),
    "passthrough": (lambda: _passthrough_plan(_JaxCore),
                    lambda: _passthrough_plan(tcore)),
}


def _both(name, seed=0):
    """(jax plan, jax model, jax variables, port plan, port net, x numpy)."""
    jplan, tplan = PLANS[name][0](), PLANS[name][1]()
    rng = np.random.default_rng(seed)
    model, variables = create_derived(jplan, jax.random.PRNGKey(seed),
                                      input_hw=HW, dtype=jnp.float32)
    x = rng.standard_normal((1, *HW, 3)).astype(np.float32)
    _, upd = model.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], **upd})
    net = DerivedNet(tplan)
    load_reference_state_dict(net, from_jax_variables(tplan, variables))
    return jplan, model, variables, tplan, net, x


@pytest.mark.parametrize("name", list(PLANS))
def test_derived_net_matches_jax(name):
    """from_jax_variables + the port's plain DerivedNet == the JAX
    DerivedNet (eval) on the same weights: 1/8 logits and x8 logits."""
    _, model, variables, _, net, x = _both(name)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_loader_ignores_extra_keys_and_raises_on_missing():
    _, _, variables, tplan, net, _ = _both("passthrough")
    sd = from_jax_variables(tplan, variables)
    sd["heads16.conv_1x1.weight"] = torch.zeros(1)   # an aux head: unused
    load_reference_state_dict(DerivedNet(tplan), sd)
    del sd["ffm.conv_1x1.bn.running_var"]
    with pytest.raises(KeyError, match="running_var"):
        load_reference_state_dict(DerivedNet(tplan), sd)
