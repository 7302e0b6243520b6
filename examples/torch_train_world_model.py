"""Pre-train a transformer world model on the PyTorch port: a few hundred
train steps on synthetic trajectory tokens.

Model: a scaled-down GLM-4-family decoder (~10M params by default;
``--big`` for ~100M). Data: ``DynamicsTokenStream``, a seeded synthetic
'tokenised dynamics' stream (s_{t+1} = f(s_t, a_t) mod V) standing in for
the trajectory tokeniser of a Dyna-style world model. The step is
``api.build(..., "train")``: Adam at the config's ``lr`` over the plain
attention by autograd (the kernel is forward-only, as the reference's has
no backward). The port of ``examples/train_world_model.py``::

    PYTHONPATH=src python examples/torch_train_world_model.py       # the card
    PYTHONPATH=src python examples/torch_train_world_model.py --device cpu \\
        --steps 20
"""
import argparse
import time

from repro_torch import resolve_device
from repro_torch.data.synthetic import DynamicsTokenStream
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim.optimizers import adam

SMALL = ModelConfig(name="wm-10m", family="dense", num_layers=4,
                    d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
                    vocab_size=2048)
BIG = ModelConfig(name="wm-100m", family="dense", num_layers=12,
                  d_model=768, num_heads=12, num_kv_heads=4, d_ff=3072,
                  vocab_size=8192)


def main(big: bool = False, steps: int = 200, batch: int = 8, seq: int = 64,
         device=None):
    dev = resolve_device(device)
    cfg = BIG if big else SMALL
    bundle = api.build(cfg, InputShape("wm", seq, batch, "train"),
                       device=dev)
    params = LM.init_params(cfg, 0, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"world model {cfg.name}: {n / 1e6:.1f}M params")
    opt_state = adam(cfg.lr).init(LM.trainable(params))
    stream = DynamicsTokenStream(cfg.vocab_size, seq, batch, seed=0,
                                 device=dev)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        params, opt_state, m = bundle.fn(params, opt_state,
                                         stream.batch_at(step))
        if step % max(steps // 10, 1) == 0 or step == steps - 1:
            losses.append(float(m["loss"]))
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)",
                  flush=True)
    print("final loss should approach 0: the dynamics are deterministic.")
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(a.big, a.steps, a.batch, a.seq, a.device)
