"""The hill-climb runner on the port's dry run (the counterpart of
`scripts/run_hillclimb.py`): re-runs the three chosen (arch x shape)
cells with one lever flipped per variant, each in a fresh process (the
dry run's fake world and the levers' environment variables are read when
it starts).

    python scripts/run_hillclimb_torch.py                 # every variant
    python scripts/run_hillclimb_torch.py --only deepseek

Each variant's cell goes to `<results>/hillclimb_torch/<tag>/` (`--results`,
default `results`); a cell already there is kept.  The levers are the
reference's environment variables, which the port reads at the same
places: `REPRO_MOE_GROUP` (models/moe.py), `REPRO_CAPACITY` and
`REPRO_PARAM_DTYPE` (launch/dryrun.py), `REPRO_LOSS_MODE`
(train/train_step.py), `REPRO_NO_FSDP` (models/sharding.py) and
`REPRO_HEAD_RESHARD` (models/transformer.py).  The reference's fifth,
`REPRO_BLOCK_CONSTRAINT`, has no switch in the port, whose transformer
always takes that layout, so its variants D4 and D5 are left out.  A
variant whose dry run fails is named on stderr, and the script then
exits with 1.
"""
import argparse
import os
import subprocess
import sys

# the reference's plan (scripts/run_hillclimb.py): (tag, arch, shape, env),
# one lever per step, cumulative per cell
PLAN = [
    # A. deepseek train_4k: worst memory term, most-MoE-representative
    ("A1_moe_group16", "deepseek_v2_236b", "train_4k",
     {"REPRO_MOE_GROUP": "16"}),
    ("A2_plus_cap125", "deepseek_v2_236b", "train_4k",
     {"REPRO_MOE_GROUP": "16", "REPRO_CAPACITY": "1.25"}),
    ("A3_plus_onehot", "deepseek_v2_236b", "train_4k",
     {"REPRO_MOE_GROUP": "16", "REPRO_CAPACITY": "1.25",
      "REPRO_LOSS_MODE": "onehot"}),
    # B. qwen train_4k: worst roofline fraction (tiny model, huge vocab)
    ("B1_onehot_loss", "qwen1_5_0_5b", "train_4k",
     {"REPRO_LOSS_MODE": "onehot"}),
    ("B2_plus_nofsdp", "qwen1_5_0_5b", "train_4k",
     {"REPRO_LOSS_MODE": "onehot", "REPRO_NO_FSDP": "1"}),
    ("B3_plus_bf16params", "qwen1_5_0_5b", "train_4k",
     {"REPRO_LOSS_MODE": "onehot", "REPRO_NO_FSDP": "1",
      "REPRO_PARAM_DTYPE": "bfloat16"}),
    # C. phi3 train_4k: largest collective seconds of the dense cells
    ("C1_bf16_params", "phi3_medium_14b", "train_4k",
     {"REPRO_PARAM_DTYPE": "bfloat16"}),
    ("C2_plus_onehot", "phi3_medium_14b", "train_4k",
     {"REPRO_PARAM_DTYPE": "bfloat16", "REPRO_LOSS_MODE": "onehot"}),
    # D. the head's weight resharded, and the residual's sharding pinned
    ("D1_head_reshard_qwen", "qwen1_5_0_5b", "train_4k",
     {"REPRO_HEAD_RESHARD": "1"}),
    ("D2_head_reshard_phi3", "phi3_medium_14b", "train_4k",
     {"REPRO_HEAD_RESHARD": "1"}),
    ("D3_head_reshard_deepseek", "deepseek_v2_236b", "train_4k",
     {"REPRO_HEAD_RESHARD": "1", "REPRO_MOE_GROUP": "16"}),
    # the reference's D4 and D5 flip REPRO_BLOCK_CONSTRAINT, whose layout
    # the port always takes (models/transformer.py): they would repeat D2
    # and D1, so they are not run
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--results", default="results")
    args = ap.parse_args(argv)
    root = os.path.join(args.results, "hillclimb_torch")
    os.makedirs(root, exist_ok=True)
    ran, failed = [], []
    for tag, arch, shape, env in PLAN:
        if args.only and args.only not in tag and args.only not in arch:
            continue
        outdir = os.path.join(root, tag)
        if os.path.exists(os.path.join(outdir, f"{arch}__{shape}__pod.json")):
            print(f"cached {tag}")
            continue
        print(f"=== {tag} ({arch} {shape}) env={env} ===", flush=True)
        e = dict(os.environ, PYTHONPATH="src", **env)
        rc = subprocess.run([sys.executable, "-m",
                             "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape, "--out", outdir],
                            env=e, check=False).returncode
        (ran if rc == 0 else failed).append(tag)
    if failed:
        print(f"failed variants: {', '.join(failed)}", file=sys.stderr)
        raise SystemExit(1)
    return ran


if __name__ == "__main__":
    main()
