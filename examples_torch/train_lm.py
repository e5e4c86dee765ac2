"""End-to-end training example: a reduced granite-MoE trained for a few
hundred steps with the fault-tolerant driver (async checkpoints; kill and
re-run to watch it resume).

The port's counterpart of ``examples/train_lm.py``: the same config,
optimizer, loop and data, the weights drawn from the torch seed of the
loop (``init_train_state`` on a CPU generator), trained on the card (its
attention forward through the flash kernel, in float32) or, with
``--device cpu``, on the CPU.

  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch import data as data_mod
from repro_torch import optim
from repro_torch.configs import get_config, smoke
from repro_torch.launch import train as train_mod


def main(argv=None):
    """Trains; returns the ``TrainResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke(get_config("granite-moe-3b-a800m"))  # tiny MoE, same family
    opt = optim.OptConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    loop = train_mod.TrainLoopConfig(steps=args.steps, ckpt_every=50,
                                     ckpt_dir=args.ckpt, log_every=20)
    dcfg = data_mod.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                               input_mode=cfg.input_mode,
                               d_model=cfg.d_model)

    def log(step, loss, dt):
        print(f"step {step:4d}  loss {loss:7.4f}  {dt * 1e3:7.1f} ms")

    res = train_mod.train(cfg, opt, loop, dcfg, hooks={"log": log},
                          device=args.device)
    if res.restored_from is not None:
        print(f"(resumed from checkpointed step {res.restored_from})")
    first = sum(res.losses[:10]) / max(len(res.losses[:10]), 1)
    last = sum(res.losses[-10:]) / max(len(res.losses[-10:]), 1)
    print(f"loss: first10 {first:.4f} -> last10 {last:.4f}")
    assert last < first, "loss did not improve"
    return res


if __name__ == "__main__":
    main()
