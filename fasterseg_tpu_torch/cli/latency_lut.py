"""CLI: measure the latency LUT on the card through the port's kernels.

Counterpart of the JAX package's cli/latency_lut.py (the reference's
`python latency/latency_lookup_table.py`, latency_lookup_table.py:18-113),
in the same three parts and order:

1. every searchable op at every (scale in {8, 16, 32}, width in, width out,
   stride in {1, 2}) of the 1024x2048 base resolution, under its true key;
2. every key of the supernet latency tables and both stems;
3. the derived walks of the shipped teacher and student genotypes at lasts
   [2, 0] and [2, 1] (their aggregation ConvNorm, FFM and head keys), with
   `--num-classes` classes (19; the ProcCity chain's heads have 8).

Each key is timed by `latency.measure.measured_provider`: the op built with
seeded random weights, folded and packed once, run through the serving route
(the conv kernels, the 1x1 products, the matrix resizes) at batch 1 and
slope-timed over CUDA graph replays. Entries are saved as they come, so a run
resumes where it stopped (keys already in the table are skipped), and
`--max-entries` bounds a run.

  python -m fasterseg_tpu_torch.cli.latency_lut --out h100_lut.json
  python -m fasterseg_tpu_torch.cli.latency_lut --num-classes 8 \
      --out fasterseg_tpu_torch/latency/h100_lut.json   # adds the 8-class heads
"""

from __future__ import annotations

import argparse
import json
import os
import time


class _Budget(Exception):
    pass


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="latency_lut.json")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--Fch", type=int, default=12)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--num-classes", type=int, default=19,
                   help="classes of the walks' heads (part 3)")
    p.add_argument("--max-entries", type=int, default=None,
                   help="stop after N new measurements (resumable)")
    p.add_argument("--arch", nargs="*", default=None,
                   help="genotype .npz files for the coverage pass "
                        "(default: the shipped teacher/student assets)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                        "versions, for tests)")
    args = p.parse_args(argv)

    import torch

    from ..core.config import WIDTH_MULT_LIST
    from ..core.genotype import ArchParams, decode_network
    from ..core.plan import build_plan, num_filters
    from ..latency import LatencyLUT
    from ..latency.derived import derived_latency_ms
    from ..latency.measure import measured_provider
    from ..latency.tables import build_supernet_tables, stem_latency_ms
    from ..models import _ASSETS
    from ..ops.slimmable import make_divisible

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    lut = LatencyLUT(args.out)
    H, W = args.height, args.width
    base = measured_provider(dtype=dtype, device=args.device)
    count = {"new": 0}

    def provider(name):
        if args.max_entries is not None and count["new"] >= args.max_entries:
            raise _Budget()
        ms = base(name)
        count["new"] += 1
        return ms

    lut.provider = provider
    walks = {}
    t0 = time.perf_counter()
    try:
        # 1. the full op sweep, true keys (latency_lookup_table.py:18-75)
        for scale in (8, 16, 32):
            h, w = H // scale, W // scale
            c_max = num_filters(scale, args.Fch)
            for wi in WIDTH_MULT_LIST:
                c_in = make_divisible(c_max * wi)
                for wo in WIDTH_MULT_LIST:
                    for stride in (1, 2):
                        c_out = make_divisible(
                            (c_max * 2 if stride == 2 else c_max) * wo)
                        for op_idx in range(5):
                            if op_idx == 0 and stride == 1 and c_in != c_out:
                                continue  # identity skip needs equal widths
                            lut.get_op(op_idx, h, w, c_in, c_out, stride)

        # 2. the supernet tables and both stems: what the search asks for
        build_supernet_tables(lut, args.layers, args.Fch, WIDTH_MULT_LIST,
                              (H, W))
        for sw in (1.0, 8.0 / 12):
            stem_latency_ms(lut, args.Fch, sw, (H, W))

        # 3. the derived walks of the shipped genotypes (the aggregation
        # ConvNorm, ff and head keys the plans use)
        arch_paths = args.arch
        if arch_paths is None:
            arch_paths = [os.path.join(_ASSETS, f"arch_{i}.npz")
                          for i in (0, 1)]
        for idx, path in enumerate(arch_paths):
            if not os.path.isfile(path):
                print(f"skipping missing genotype {path}")
                continue
            ap = ArchParams.from_npz(path)
            teacher = idx == 0
            shw = (1.0, 1.0) if teacher else (8.0 / 12, 8.0 / 12)
            genos = decode_network(ap, WIDTH_MULT_LIST, args.layers,
                                   ignore_skip=teacher)
            for lasts in ([2, 0], [2, 1]):
                plan = build_plan(genos, lasts, Fch=args.Fch,
                                  num_classes=args.num_classes,
                                  stem_head_width=shw)
                ms = derived_latency_ms(lut, plan, (H, W))
                walks[f"arch_{idx}_{lasts[0]}{lasts[1]}"] = ms
                print(f"arch {idx} lasts={lasts}: {ms:.4f} ms "
                      f"({1000.0 / ms:.1f} FPS)")
    except _Budget:
        print(f"budget reached: {count['new']} new entries")

    lut.save()
    seconds = time.perf_counter() - t0
    print(f"LUT: {len(lut)} entries ({count['new']} new) -> {args.out}")
    print(json.dumps({"entries": len(lut), "new": count["new"],
                      "seconds": seconds, "walks_ms": walks}))
    return lut


if __name__ == "__main__":
    main()
