"""Lock-step serving of an encoder-decoder (Seamless-M4T) on the PyTorch
port: a batch of requests, each a clip of audio frames and a text prompt.

The audio frontend is stubbed, as in the reference: each request brings
precomputed frame embeddings. Prefill encodes the frames (the encoder's
attention runs without the causal mask), runs the decoder over the prompt
with cross-attention to the encoder's output (through the flash-attention
kernel on the card), then decodes greedily in lock step against the
static cross cache::

    PYTHONPATH=src python examples/torch_encdec_serve.py           # the card
    PYTHONPATH=src python examples/torch_encdec_serve.py --device cpu
    PYTHONPATH=src python examples/torch_encdec_serve.py --full    # 12 + 12
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models import encdec as E
from repro_torch.models.config import InputShape

FRAMES, PROMPT, GEN, BATCH = 128, 32, 16, 4


def main(device=None, full: bool = False):
    dev = resolve_device(device)
    cfg = get_config("seamless-m4t-medium", reduced=not full)
    pre = api.build(cfg, InputShape("p", PROMPT, BATCH, "prefill"),
                    device=dev)
    dec = api.build(cfg, InputShape("d", PROMPT + GEN, BATCH, "decode"),
                    device=dev)
    # independent streams for weights and requests
    params = E.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((BATCH, FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = pre.fn(params, {"tokens": prompts,
                                    "enc_embeds": frames})
    # grow the self cache to the decode length; the cross cache stays
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
    print(f"{cfg.name}: served {BATCH} requests of {FRAMES} frames and "
          f"{PROMPT} prompt tokens, generated {GEN} tokens each")
    print(f"prefill: {t_prefill * 1e3:.1f} ms   "
          f"decode: {t_decode / (GEN - 1) * 1e3:.1f} ms/token ({dev.type})")
    print("sample continuation token ids:", out[0].tolist())
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    ap.add_argument("--full", action="store_true",
                    help="the whole Seamless-M4T-medium, not its REDUCED")
    args = ap.parse_args()
    main(device=args.device, full=args.full)
