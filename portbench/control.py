"""The control of the check that decides ``correct``: the float64 reference
with every EM matrix product in TF32 (the precision below the
configurations' float32 with TF32 off), judged in the program's place on
the same sampled stream-frames as the program, over several seeds in one
process. Not part of a benchmark run.

    python -m portbench.control --workload <name> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: the program's numbers and the control's, each
with its verdict against the cell's limits. On the CPU (``--device cpu``)
it runs the port's plain kernels.
"""

from __future__ import annotations

import argparse
import json

from portbench import run, spec


def readings(cell: dict, seeds, seconds: float, device: str = "cuda"):
    """One record a seed: {"seed", "program", "control", "program_correct",
    "control_correct"} (numbers by name)."""
    out = []
    for seed in seeds:
        result, _ = run.run(cell, seed, seconds, False, device=device, control=True)
        prog, ctl = result["numbers"], result["control_numbers"]
        limits = cell["cell"]["limits"]
        out.append({"seed": seed, "program": {k: prog[k] for k in limits},
                    "control": {k: ctl[k] for k in limits},
                    "program_correct": all(float(prog[k]) <= limits[k] for k in limits),
                    "control_correct": result["correct"],
                    "program_numbers": prog, "control_numbers": ctl,
                    "metrics": {k: v["value"] for k, v in result["metrics"].items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.cache_dirs()
    for rec in readings(spec.cell(args.workload), args.seeds, args.seconds, args.device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
