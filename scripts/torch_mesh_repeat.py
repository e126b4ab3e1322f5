"""Does phase 11 of chip_smoke.py repeat on this card? Its runs against a
world of one, with torch's default algorithms and with its deterministic
ones.

    python3 scripts/torch_mesh_repeat.py [--repeats 3]

For 11a (the flagship on make_mesh(2), the res kernel) and 11b (implicit
conv on (1, 5), the grad kernel), the ranks sharing cuda:0 over gloo:
  1. with the default algorithms, the world of one run twice: bit for bit
     or not, and the two runs' differences (chip_smoke.py ``differences``);
  2. with the deterministic ones (chip_smoke.py ``deterministic``), the
     world of one twice and the mesh twice: bit for bit or not, and the
     mesh's and the plain version's differences from the world of one;
  3. with the default algorithms, ``--repeats`` times: the mesh, the world
     of one and the plain version's world of one, and each difference's
     share of phase 11's bound, max(PAR_FLOOR, twice the plain version's).
Each line ends with the card's name and power limit; the last line is one
JSON object of the numbers. Without a card it exits 2.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def same(a, b):
    """Two worker results bit for bit: metrics, parameters, optimizer state."""
    return a["metrics"] == b["metrics"] and cs.rel_norm_tree(
        a["snapshots"], b["snapshots"]) == 0


def shares(worst, ctl):
    return {n: round(v / max(cs.PAR_FLOOR, 2 * ctl[n]), 3)
            for n, v in worst.items() if n != "metrics"}


def cell(torch, launch, joint_steps, line_args, dp, sp, repeats, what, card):
    dev = torch.device("cuda:0")
    spec = cs.line_spec(line_args)
    mesh_spec, devices = dict(spec, dp=dp, sp=sp), ["cuda:0"] * (dp * sp)
    plain_spec = dict(spec, cfg=dict(spec["cfg"], use_kernels=False))
    a, b = joint_steps(dev, spec), joint_steps(dev, spec)
    out = {"default_repeat": {"bitwise": same(a, b), "diff": cs.differences(b, a)}}
    print(f"{what} default algorithms: the world of one against its repeat, "
          f"bit for bit {same(a, b)}, {cs.show(out['default_repeat']['diff'])} "
          f"| {card}", flush=True)
    with cs.deterministic():
        a, b = joint_steps(dev, spec), joint_steps(dev, spec)
        plain = joint_steps(dev, plain_spec)
    m1 = launch(cs.deterministic_worker, devices, joint_steps, mesh_spec)[0]
    m2 = launch(cs.deterministic_worker, devices, joint_steps, mesh_spec)[0]
    out["deterministic"] = {"one_bitwise": same(a, b), "mesh_bitwise": same(m1, m2),
                            "mesh": cs.differences(m1, a),
                            "plain": cs.differences(plain, a)}
    print(f"{what} deterministic algorithms: the world of one repeats bit for bit "
          f"{same(a, b)}, the mesh {same(m1, m2)}; the mesh against the world of "
          f"one {cs.show(out['deterministic']['mesh'])}, the plain version "
          f"{cs.show(out['deterministic']['plain'])} | {card}", flush=True)
    out["default_shares"] = []
    for r in range(repeats):
        mesh = launch(joint_steps, devices, mesh_spec)[0]
        one, plain = joint_steps(dev, spec), joint_steps(dev, plain_spec)
        share = shares(cs.differences(mesh, one), cs.differences(plain, one))
        out["default_shares"].append(share)
        print(f"{what} default algorithms, repeat {r}: each difference's share "
              f"of its bound {share} | {card}", flush=True)
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    opt = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_repeat: no CUDA device", file=sys.stderr)
        return 2
    from ardae_tpu_torch.ops import fused_dsm, fused_dsm_grad
    from ardae_tpu_torch.parallel.launch import launch
    from ardae_tpu_torch.parallel.workers import joint_steps

    fused_dsm.build_library()
    fused_dsm_grad.build_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, t0 = cs.card_line(), time.perf_counter()
    out = {"card": card}
    for key, args, dp, sp, what in (
            ("flagship", cs.FLAGSHIP_ARGS, 2, 1, "11a flagship (2, 1)"),
            ("implicit_conv", cs.IMPLICIT_CONV_ARGS, 1, 5, "11b implicit conv (1, 5)")):
        out[key] = cell(torch, launch, joint_steps, args, dp, sp, opt.repeats, what,
                        card)
    print(f"torch_mesh_repeat: done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
