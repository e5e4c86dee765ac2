"""Traffic/FLOP breakdown for one dry-run cell: which ops dominate the
memory and compute roofline terms.

Counterpart of ``repro.roofline.breakdown``: where the reference groups
the compiled HLO's ops by their ``op_name``, this groups the census of
one rank's step (``roofline.census``, run as ``launch.dryrun`` runs a
cell) by aten op, and by kernel: the hand-written kernels of
``kernels/csrc`` (their ``repro_torch`` operators) against the PyTorch
library's ops.  Runs on ``meta`` tensors; no card.

  PYTHONPATH=src python -m repro_torch.roofline.breakdown \\
      --arch phi3-mini-3.8b --shape train_4k --mesh single --top 20
"""
import argparse
from collections import defaultdict


def kernel_of(op: str) -> str:
    """The kernel class of a census op name (``namespace.name``)."""
    ns = op.split(".")[0]
    if ns == "repro_torch":
        return "hand kernel"
    if ns in ("_c10d_functional", "c10d_functional", "c10d"):
        return "collective"
    return "PyTorch library"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    from repro_torch import sharding
    from repro_torch.launch import dryrun as dr
    from repro_torch.roofline import census

    cfg = dr.get_config(args.arch)
    mesh = dr.build_mesh(args.mesh)
    rules = dr.rules_for(args.arch, args.shape)
    with sharding.use_mesh(mesh, rules):
        step, cell, _ = dr.cell_args(cfg, args.arch, args.shape, mesh, rules)
        stats = census.analyze(step, *cell)

    for name, key, unit, label in (("TRAFFIC", "bytes", 1e12, "TB"),
                                   ("DOT FLOPS", "flops", 1e12, "TFLOP")):
        rows = [(getattr(t, key), op, t.calls) for op, t in stats.ops.items()
                if getattr(t, key)]
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        print(f"\n== {name}: total {total / unit:.3f} {label} per device ==")
        for v, op, calls in rows[:args.top]:
            print(f"  {v / unit:10.3f}  {op:40s} {calls:6d} calls")
        by_kernel = defaultdict(float)
        for v, op, _ in rows:
            by_kernel[kernel_of(op)] += v
        print("  by kernel: " + ", ".join(
            f"{k} {v / unit:.3f}" for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])))
    print(f"\n== COLLECTIVE: total {stats.collective_bytes / 1e9:.3f} GB per "
          f"device, {stats.collective_count} calls ==")
    for kind, b in sorted(stats.collective_bytes_by_kind.items(),
                          key=lambda kv: -kv[1]):
        print(f"  {b / 1e9:10.3f}  {kind}")
    print(f"\n== MEMORY: peak {stats.peak_bytes / 2**30:.3f} GiB per device, "
          f"of which arguments {stats.argument_bytes / 2**30:.3f} GiB ==")


if __name__ == "__main__":
    main()
