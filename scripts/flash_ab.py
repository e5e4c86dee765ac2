"""The bfloat16 flash kernel of several source trees timed side by side,
on one CUDA card.

    python scripts/flash_ab.py TREE [TREE ...]

Each TREE is a directory that holds a ``src/repro_torch`` (a parent
commit unpacked by ``git archive`` into a git-ignored directory, say, or
a copy with an edited ``csrc/flash_attention.cu``).  Each is timed in a
process of its own, in the order given (name a tree twice, as in
``parent change change parent``, to see the spread): its package is
imported from the tree and its kernel built into the tree's
``build/kernels/``.  The shapes, inputs and timer are ``chip_smoke.py``'s
``[kernels:flash]``: its ``FLASH_CASES`` named in ``CASES`` (phi3-mini's
prefill and recurrentgemma-9b's two), q, k and v from ``_flash_inputs``
on a CUDA generator seeded 0, and ``device_ms`` over ``ITERS`` calls (a
call from its first grid's start to its last grid's end).  Prints one
line per tree, then the card's name and power limit.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("phi3", "recurrentgemma prefill", "recurrentgemma 2 x 4096")


def time_tree(tree: str) -> str:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    assert FA.__file__.startswith(os.path.abspath(tree)), FA.__file__
    build.build(["flash_attention"])
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for name, (B, S, H, KV, D), dt, opts in cs.FLASH_CASES:
        if name not in CASES:
            continue
        q, k, v = cs._flash_inputs(g, B, S, H, KV, D, dt)
        ms = cs.device_ms(lambda: FA.flash_attention_fwd(q, k, v, **opts),
                          cs.ITERS, "flash_fwd_kernel")
        out.append(f"{name} {ms:.6f} ms")
    return f"{tree}: " + "; ".join(out)


def main(argv):
    if argv[:1] == ["--one"]:
        print(time_tree(argv[1]), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
