"""The control of a cell's check: the plain reference put in the
program's place and computed in the precision below the one the
configuration states (float32 -> bfloat16: reference/tracer.py
`BFLOAT16`), judged by the cell's own check against the float32
reference, on each seed given.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        [--samples N]

`--samples` is the samples each sampled pixel holds: a cell whose units
fold into one sensor holds a window's worth (give the frames a run of
the cell holds); a cell whose units are images holds the configuration's
`spp`, the default. Prints one line a seed with each number beside its
limit, and a last line of JSON; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__" and str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(root, bench, workload: str, seed: int, samples: int | None,
            device) -> dict:
    """{name: (value, limit)} of the control on one seed."""
    import importlib

    from portbench import run as R
    from portbench.reference import check as C
    from portbench.reference import tracer as T

    _, config, traffic = R.cell_files(root, bench, workload)
    scene = importlib.import_module(f"portbench.scenes.{traffic['scene']}")
    desc = scene.make(seed, **traffic["scene_args"])
    n = samples or config["spp"]
    flat_ids = C.sample_pixels(seed, config["height"], config["width"],
                               config["check"]["pixels"])
    ref = C.reference_values(desc, config, flat_ids, n, device)
    low = C.reference_values(desc, config, flat_ids, n, device, T.BFLOAT16)
    image = np.zeros((config["height"] * config["width"], 3), np.float32)
    image[flat_ids] = low
    numbers, _ = C.judge([image.reshape(config["height"], config["width"], 3)],
                         n, n, ref, flat_ids, config["check"]["limits"])
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import run as R
    from portbench.reference import check as C

    bench = R.load_json(ROOT / "BENCHMARK.json")
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = control(ROOT, bench, args.workload, seed, args.samples,
                          args.device)
        print(f"control {args.workload} seed {seed} ({time.perf_counter() - t:.1f} s): "
              + ", ".join(f"{k} {v!r} limit {lim!r}"
                          for k, (v, lim) in numbers.items())
              + f" -> correct {C.correct(numbers)}", flush=True)
        out.append({"seed": seed, "correct": C.correct(numbers),
                    **{k: v for k, (v, _) in numbers.items()}})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
