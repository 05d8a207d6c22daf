"""The port's roofline and hill-climb tables from its dry run's JSON (the
counterpart of `scripts/make_tables.py`):

    PYTHONPATH=src python scripts/make_tables_torch.py [--results results]

It reads `<results>/dryrun_torch/*.json` (`python -m
repro_torch.launch.dryrun`) and `<results>/hillclimb_torch/*/*.json`
(`scripts/run_hillclimb_torch.py`) and writes
`<results>/roofline_table_torch.md` and
`<results>/hillclimb_table_torch.md`.  The terms are the dry run's
prediction for a mesh of H100s (`repro_torch.launch.roofline`: the
card's data-sheet rates), not a measurement.
"""
import argparse
import glob
import json
import os
import sys


def load(pattern):
    out = []
    for p in sorted(glob.glob(pattern)):
        with open(p) as f:
            out.append(json.load(f))
    return out


def _analytic_mem_s(c):
    sys.path.insert(0, "src")
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import HBM_BW, analytic_hbm_bytes
    from repro_torch.models.config import SHAPES
    cfg = get_config(c["arch"])
    return analytic_hbm_bytes(cfg, SHAPES[c["shape"]], c["chips"]) / HBM_BW


def roofline_md(cells):
    rows = ["| arch | shape | mesh | compute s | memory s (traced) | "
            "mem s (HBM est) | coll s | bottleneck* | frac* | 6ND/traced | "
            "coll GB/dev |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        mem_a = _analytic_mem_s(c)
        bound = max(c["compute_s"], mem_a, c["collective_s"])
        bneck = {c["compute_s"]: "compute", mem_a: "memory",
                 c["collective_s"]: "collective"}[bound]
        frac = c["compute_s"] / max(bound, 1e-30)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {c['compute_s']:.4g} | {c['memory_s']:.4g} "
            f"| {mem_a:.4g} | {c['collective_s']:.4g} "
            f"| {bneck} | {frac:.3f} "
            f"| {min(c['useful_flops_ratio'], 99):.2f} "
            f"| {c['collective_bytes_per_dev'] / 1e9:.1f} |")
    rows.append("")
    rows.append("\\* bottleneck/fraction use the fused-HBM estimate for the "
                "memory term; the traced-bytes term is also shown (it "
                "counts every op's operands and results, before any "
                "fusion).")
    return "\n".join(rows)


def _corrected_bound(c):
    return max(c["compute_s"], _analytic_mem_s(c), c["collective_s"])


def hillclimb_md(base_cells, results="results"):
    base = {(c["arch"], c["shape"]): c for c in base_cells}
    rows = ["| variant | arch/shape | compute s | mem s (traced) | coll s | "
            "bound s* | frac* | Δbound | Δcoll | Δmem(traced) |",
            "|---|---|---|---|---|---|---|---|---|---|"]

    def row(tag, c, b):
        bound = _corrected_bound(c)
        frac = c["compute_s"] / max(bound, 1e-30)
        if b is not None:
            b_bound = _corrected_bound(b)
            d_bound = f"{(1 - bound / b_bound) * 100:+.1f}%"
            d_coll = (f"{(1 - c['collective_s'] / max(b['collective_s'], 1e-30)) * 100:+.1f}%")
            d_mem = (f"{(1 - c['memory_s'] / max(b['memory_s'], 1e-30)) * 100:+.1f}%")
        else:
            d_bound = d_coll = d_mem = "baseline"
        rows.append(f"| {tag} | {c['arch']}/{c['shape']} "
                    f"| {c['compute_s']:.4g} | {c['memory_s']:.4g} "
                    f"| {c['collective_s']:.4g} | {bound:.4g} | {frac:.3f} "
                    f"| {d_bound} | {d_coll} | {d_mem} |")

    seen = set()
    for d in sorted(glob.glob(os.path.join(results, "hillclimb_torch", "*",
                                           "*.json"))):
        tag = os.path.basename(os.path.dirname(d))
        with open(d) as f:
            c = json.load(f)
        key = (c["arch"], c["shape"])
        b = base.get(key)
        if b is not None and key not in seen:
            seen.add(key)
            row("baseline", b, None)
        row(tag, c, b)
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results")
    args = ap.parse_args(argv)
    cells = load(os.path.join(args.results, "dryrun_torch", "*.json"))
    os.makedirs(args.results, exist_ok=True)
    roof = os.path.join(args.results, "roofline_table_torch.md")
    hill = os.path.join(args.results, "hillclimb_table_torch.md")
    with open(roof, "w") as f:
        f.write(roofline_md(cells) + "\n")
    with open(hill, "w") as f:
        f.write(hillclimb_md(cells, args.results) + "\n")
    print(f"{len(cells)} baseline cells -> {roof}")
    print(f"hillclimb -> {hill}")
    return roof, hill


if __name__ == "__main__":
    main()
