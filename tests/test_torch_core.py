"""fasterseg_tpu_torch core (decode, plan) and resize matrices against the
JAX package and the golden reference decode."""

import dataclasses

import numpy as np
import pytest
import torch

import fasterseg_tpu.core as jcore
import fasterseg_tpu.models as jmodels
from fasterseg_tpu.ops import resize as jresize
import fasterseg_tpu_torch.core as tcore
import fasterseg_tpu_torch.models as tmodels
from fasterseg_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("arch_idx,ignore_skip", [(0, True), (1, False)])
def test_decode_matches_golden(assets_dir, golden_decode, arch_idx,
                               ignore_skip):
    arch = tcore.ArchParams.from_npz(f"{assets_dir}/arch_{arch_idx}.npz")
    genos = tcore.decode_network(arch, tcore.WIDTH_MULT_LIST, layers=16,
                                 ignore_skip=ignore_skip)
    gold = golden_decode[f"arch_{arch_idx}"]
    for last in (0, 1, 2):
        g, ref = genos[last], gold[f"last{last}"]
        assert list(g.ops) == ref["ops"]
        assert list(g.path) == ref["path"]
        assert list(g.downs) == ref["downs"]
        np.testing.assert_allclose(list(g.widths), ref["widths"], rtol=1e-9)


@pytest.mark.parametrize("arch_idx,ignore_skip,shw,lasts", [
    (0, True, (1.0, 1.0), [2, 1]),
    (1, False, (8.0 / 12, 8.0 / 12), [2, 1]),
    (1, False, (8.0 / 12, 8.0 / 12), [2, 0]),
])
def test_plan_matches_jax(assets_dir, arch_idx, ignore_skip, shw, lasts):
    path = f"{assets_dir}/arch_{arch_idx}.npz"
    plans = []
    for core in (jcore, tcore):
        genos = core.decode_network(core.ArchParams.from_npz(path),
                                    core.WIDTH_MULT_LIST, layers=16,
                                    ignore_skip=ignore_skip)
        plans.append(core.build_plan(genos, lasts, Fch=12, num_classes=19,
                                     stem_head_width=shw))
    jplan, tplan = plans
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tplan.head_width() == jplan.head_width()
    assert tplan.ffm_channels == jplan.ffm_channels


@pytest.mark.parametrize("name", ["student_plan", "teacher_plan"])
def test_shipped_plans_match_jax(name):
    assert (dataclasses.asdict(getattr(tmodels, name)())
            == dataclasses.asdict(getattr(jmodels, name)()))


@pytest.mark.parametrize("in_size,out_size", [
    (16, 128), (128, 1024), (28, 14), (64, 32), (7, 7), (5, 1), (1, 4)])
def test_interp_matrix_matches_jax(in_size, out_size):
    np.testing.assert_array_equal(
        tresize._interp_matrix_np(in_size, out_size),
        jresize._interp_matrix_np(in_size, out_size))
    for a, b in zip(tresize._ac_coords(in_size, out_size),
                    jresize._ac_coords(in_size, out_size)):
        np.testing.assert_array_equal(a, b)


def test_resizes_match_jax(rng):
    """resize_bilinear / scale_by / downsample_half, NHWC, fp32."""
    x = rng.standard_normal((1, 28, 56, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    import jax.numpy as jnp
    xj = jnp.asarray(x)
    pairs = [
        (tresize.resize_bilinear(xt, (40, 24)),
         jresize.resize_bilinear(xj, (40, 24))),
        (tresize.scale_by(xt, 8), jresize.scale_by(xj, 8)),
        (tresize.downsample_half(xt), jresize.downsample_half(xj)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
