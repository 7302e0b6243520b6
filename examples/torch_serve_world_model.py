"""Lock-step serving of a world model on the PyTorch port: a batch of
requests against a small GLM-4-family decoder.

Prefill a batch of token prompts (through the flash-attention kernel on
the card), grow the KV cache, then decode greedily in lock step: the
whole batch starts and stops together. The continuous-batching tier
is ``python -m repro_torch.serve``. The port of
``examples/serve_world_model.py``::

    PYTHONPATH=src python examples/torch_serve_world_model.py      # the card
    PYTHONPATH=src python examples/torch_serve_world_model.py --device cpu
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape

PROMPT, GEN, BATCH = 48, 16, 8


def main(device=None):
    dev = resolve_device(device)
    cfg = get_config("glm4-9b", reduced=True)
    pre = api.build(cfg, InputShape("p", PROMPT, BATCH, "prefill"),
                    device=dev)
    dec = api.build(cfg, InputShape("d", PROMPT + GEN, BATCH, "decode"),
                    device=dev)
    # independent streams for weights and request tokens
    params = LM.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = pre.fn(params, {"tokens": prompts})
    # grow the cache to the decode length (pos pads with -1 = empty)
    cache = api.grow_cache(cache, PROMPT + GEN + 1)
    tok = logits[:, :cfg.vocab_size].argmax(-1)[:, None].to(torch.int32)
    sync()
    t_prefill = time.perf_counter() - t0

    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(GEN - 1):
        logits, cache = dec.fn(params, cache, tok)
        tok = logits[:, :cfg.vocab_size].argmax(-1)[:, None].to(torch.int32)
        generated.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    out = torch.cat(generated, 1)
    print(f"served {BATCH} requests: prompt {PROMPT} tokens, "
          f"generated {GEN} tokens each")
    print(f"prefill: {t_prefill * 1e3:.1f} ms   "
          f"decode: {t_decode / (GEN - 1) * 1e3:.1f} ms/token ({dev.type})")
    print("sample continuation token ids:", out[0].tolist())
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
