"""The port's slimmable ops (fasterseg_tpu_torch/ops/slimmable.py) against
the reference's sliced ops and the JAX package's masked ones, on the CPU in
fp32.

* Against tests/assets/slim_parity.npz, read directly (the reference's
  USConv2d full-width weights and its per-width BN children, outputs of its
  sliced forward in eval mode): all 10 (op, stride) cases at the asset's
  width pairs, the active prefix within 2e-4 (tests/test_slimmable.py's
  bar) and exactly zero beyond it.
* Against the JAX package's masked modules, with the same weights and a
  random input, at every one of the 25 (w_in, w_out) pairs, in eval mode
  and in train mode: outputs within 1e-5 + 1e-5 |ref| (fp32; both mask, so
  the masked channels are exactly zero on both sides) and the selected BN
  row's running statistics after a train forward within 1e-6 + 1e-6 |ref|.
  Both designs mask, so those rows are compared whole, the entries beyond
  the active prefix (which decay towards 0) included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasterseg_tpu.ops.slimmable as js
from fasterseg_tpu.utils.torch_import import import_slim_op_state
from fasterseg_tpu_torch.ops import slimmable as ts
from fasterseg_tpu_torch.utils.weights import _slim_op_into

from _torch_search_common import few_threads  # noqa: F401 (autouse)

WML = (4.0 / 12, 6.0 / 12, 8.0 / 12, 10.0 / 12, 1.0)
C_IN = 48
NAMES = ["skip", "conv", "conv_downup", "conv_2x", "conv_2x_downup"]
CASES = [(op, s) for op in range(5) for s in (1, 2)]


@pytest.fixture(scope="module")
def golden(assets_dir):
    return np.load(os.path.join(assets_dir, "slim_parity.npz"))


def _state(golden, op_idx, stride):
    key = f"{NAMES[op_idx]}_s{stride}"
    return {k[len(f"{key}/state/"):]: golden[k] for k in golden.files
            if k.startswith(f"{key}/state/")}


def _port_op(op_idx, stride):
    c_out = C_IN * 2 if stride == 2 else C_IN
    return ts.SLIM_OP_CLASSES[op_idx](C_IN, c_out, stride, WML), c_out


@torch.no_grad()
def _load_reference(op, sd, c_out):
    """The reference's state_dict into the port's op: conv weights as they
    are (OIHW), each width's BN child into its row's active prefix."""
    for name, mod in op.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            ref = name[:-len(".conv")] if name.endswith(".conv") else name
            mod.weight.copy_(torch.from_numpy(sd[f"{ref}.weight"]))
        elif isinstance(mod, ts.SlimBatchNorm):
            for i, wm in enumerate(WML):
                k = ts.make_divisible(c_out * wm)
                for ours, theirs in (("weight", "weight"), ("bias", "bias"),
                                     ("running_mean", "running_mean"),
                                     ("running_var", "running_var")):
                    getattr(mod, ours)[i, :k] = torch.from_numpy(
                        sd[f"{name}.bn.{i}.{theirs}"])


def test_make_divisible_and_mask_table_match_jax():
    for v in list(range(1, 400)) + [12 * 8 * w for w in WML] + [2.5, 100.4]:
        assert ts.make_divisible(v) == js.make_divisible(v)
        assert ts.make_divisible(v, 4) == js.make_divisible(v, 4)
    for c in (16, 48, 64, 96, 128, 192, 256, 384):
        np.testing.assert_array_equal(ts.width_mask_table(c, WML),
                                      js.width_mask_table(c, WML))
        assert ts.width_index(WML[2], WML) == js.width_index(WML[2], WML)
    np.testing.assert_array_equal(ts.width_mask_table(48, WML).sum(1),
                                  [16, 24, 32, 40, 48])


@pytest.mark.parametrize("op_idx,stride", CASES)
def test_slim_op_matches_sliced_reference(golden, op_idx, stride):
    key = f"{NAMES[op_idx]}_s{stride}"
    op, c_out = _port_op(op_idx, stride)
    _load_reference(op, _state(golden, op_idx, stride), c_out)
    op.eval()
    x_full = golden[f"{key}/input"]
    seen = 0
    for k in golden.files:
        if not k.startswith(f"{key}/out/"):
            continue
        wi, wo = (float(v) for v in k.split("/")[-1].split("_"))
        i_in = min(range(5), key=lambda i: abs(WML[i] - wi))
        i_out = min(range(5), key=lambda i: abs(WML[i] - wo))
        k_in = ts.make_divisible(C_IN * WML[i_in])
        k_out = ts.make_divisible(c_out * WML[i_out])
        x = np.zeros_like(x_full)
        x[..., :k_in] = x_full[..., :k_in]
        with torch.no_grad():
            y = op(torch.from_numpy(x), torch.tensor(i_in),
                   torch.tensor(i_out)).numpy()
        np.testing.assert_allclose(y[..., :k_out], golden[k], rtol=2e-4,
                                   atol=2e-4, err_msg=k)
        assert np.all(y[..., k_out:] == 0), f"{k}: mask leak"
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("op_idx,stride", CASES)
def test_slim_op_matches_jax_masked_at_every_width_pair(golden, op_idx,
                                                        stride):
    """The same weights in both packages: the JAX package's import of the
    reference state, carried to the port by `_slim_op_into` (the per-op
    part of `from_jax_supernet_variables`)."""
    c_out = C_IN * 2 if stride == 2 else C_IN
    variables = import_slim_op_state(_state(golden, op_idx, stride), op_idx,
                                     stride, c_out, WML)
    jop = js.SLIM_OP_CLASSES[op_idx](c_max_in=C_IN, c_max_out=c_out,
                                     stride=stride, width_mult_list=WML)
    op, _ = _port_op(op_idx, stride)
    sd = {}
    _slim_op_into(sd, "op", op_idx, stride, variables["params"],
                  variables["batch_stats"])
    op.load_state_dict({k[3:]: v for k, v in sd.items()})

    x = np.random.default_rng(op_idx * 2 + stride).standard_normal(
        (2, 16, 24, C_IN)).astype(np.float32)
    f_eval = jax.jit(lambda v, x, i, o: jop.apply(v, x, i, o, False))
    f_train = jax.jit(lambda v, x, i, o: jop.apply(
        v, x, i, o, True, mutable=["batch_stats"]))
    for i_in in range(5):
        for i_out in range(5):
            ii, io = jnp.int32(i_in), jnp.int32(i_out)
            ti, to = torch.tensor(i_in), torch.tensor(i_out)
            op.eval()
            with torch.no_grad():
                y = op(torch.from_numpy(x), ti, to).numpy()
            want = np.asarray(f_eval(variables, x, ii, io))
            np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"eval {i_in} {i_out}")
            assert np.all(y[want == 0] == 0)

            fresh, _ = _port_op(op_idx, stride)
            fresh.load_state_dict(op.state_dict())
            fresh.train()
            with torch.no_grad():
                y = fresh(torch.from_numpy(x), ti, to).numpy()
            want, mut = f_train(variables, x, ii, io)
            np.testing.assert_allclose(y, np.asarray(want), rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"train {i_in} {i_out}")
            got = {}
            _slim_op_into(got, "op", op_idx, stride, variables["params"],
                          jax.tree.map(np.asarray, mut["batch_stats"]))
            for k, v in fresh.state_dict().items():
                if "running" in k:
                    np.testing.assert_allclose(
                        v.numpy(), got[f"op.{k}"].numpy(), rtol=1e-6,
                        atol=1e-6, err_msg=f"stats {k} {i_in} {i_out}")
