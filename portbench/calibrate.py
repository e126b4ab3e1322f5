"""The readings the comparison's limits are set from, on the card, at the
cell's own size, many seeds in one process (the benchmark's runs do not
run it):

  * the program: its checked steps against the plain reference, as a run
    compares them (the lower readings);
  * the control: the reference computed with TF32 products (matmul and
    cuDNN), the precision below the configuration's fp32, in the
    program's place;
  * a fault: the reference with half of each batch left out, the means
    taken over the rest, in the program's place.

    python -m portbench.calibrate --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed: {"seed", "program", "control", "half"}, each
{number: value}, and each side's readings (``checks.gaps``) under
"<side>_gaps". A state left unchanged reads 1 in ``delta_norm_gap``
(every leaf's change is 0) and needs no run.
"""

import argparse
import json
import sys

if __name__ == "__main__":
    from portbench.run import use_checkout_caches

    use_checkout_caches()

import torch  # noqa: E402

from portbench import checks, manifest  # noqa: E402
from portbench.reference import step as S  # noqa: E402
from portbench.run import checked_setup  # noqa: E402


def _tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(workload, seeds, root=None):
    """[{"seed", "program", "control", "half", ..., "control_correct"}] a
    seed."""
    from ardae_tpu_torch.cli.common import select_device

    from portbench import program as prog
    from portbench import reference as R

    cell = manifest.cell(workload, root)
    device = select_device(False)
    if cell.traffic["use_kernels"]:
        prog.load_library(R.cdae(cell.config).STYLE)
    out = []
    for seed in seeds:
        program, data, _, _, w0, obs, ref_steps = checked_setup(cell, seed, device, {})
        del program
        torch.cuda.empty_cache()
        ref = S.run_steps(cell.config, w0["model"], w0["cdae"], data, ref_steps)
        _tf32(True)
        try:
            ctrl = S.run_steps(cell.config, w0["model"], w0["cdae"], data, ref_steps)
        finally:
            _tf32(False)
        half = S.run_steps(cell.config, w0["model"], w0["cdae"], data, ref_steps, half=True)
        row = {"seed": seed}
        for side, o in (("program", obs), ("control", ctrl), ("half", half)):
            row[side] = checks.numbers(o, ref)
            row[f"{side}_gaps"] = checks.gaps(o, ref)
        if cell.limits:
            row["control_correct"] = checks.judge(row["control"], cell.limits)[0]
            row["program_correct"] = checks.judge(row["program"], cell.limits)[0]
        out.append(row)
        del data, w0, ref_steps
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    for row in readings(args.workload, args.seeds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
