"""Serving on the PyTorch port: batched prefill + greedy decode with
checkpointable serving state on one CUDA GPU — Spot-on protects
long-running batch-inference jobs the same way it protects training (the
serving caches + cursor are just a nested dict of tensors).

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

The twin of ``examples/serve_demo.py`` through ``repro_torch``, on the card
unless ``--device cpu`` is given. The mid-generation checkpoint is also
restored into a fresh template and decoded to the end: the continued
tokens must equal the uninterrupted run's.
"""

import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import make_decode_step, make_prefill
from repro_torch.train import state_template_on_device

BATCH, PROMPT_LEN, NEW_TOKENS = 4, 16, 24


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    device = torch.device(args.device)

    # hybrid: RG-LRU + local attn, reduced, at head dim 64 (the smallest the
    # card's attention kernels are built for)
    cfg = get_smoke_config("recurrentgemma-2b").scaled(head_dim=64)
    params = init_params(cfg, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=g, dtype=torch.int32)

    prefill = make_prefill(cfg, cache_len=PROMPT_LEN + NEW_TOKENS,
                           device=device)
    step = make_decode_step(cfg, device=device)

    tok, caches, pos = prefill(params, prompts)
    generated = [tok]
    with tempfile.TemporaryDirectory(prefix="spoton_serve_") as root:
        store = CheckpointStore(root)
        saved_at = None
        for i in range(NEW_TOKENS - 1):
            tok, _, caches = step(params, generated[-1][:, None], caches,
                                  pos + i)
            generated.append(tok)
            if i == NEW_TOKENS // 2:
                # Spot-on can snapshot mid-generation: caches are a pytree
                serving_state = {"caches": caches, "cursor": pos + i,
                                 "generated": torch.stack(generated, 1)}
                info = store.save(i, serving_state, kind="transparent")
                saved_at = i
                print(f"mid-generation checkpoint: {info.nbytes} bytes at "
                      f"token {i}")
        out = torch.stack(generated, dim=1)

        # a replacement instance restores the session and decodes on
        template = state_template_on_device(serving_state, device)
        state, man = store.restore(template)
    assert man.step == saved_at
    resumed = list(state["generated"].unbind(1))
    caches, cursor = state["caches"], state["cursor"]
    for i in range(NEW_TOKENS - len(resumed)):
        tok, _, caches = step(params, resumed[-1][:, None], caches,
                              cursor + 1 + i)
        resumed.append(tok)
    resumed = torch.stack(resumed, dim=1)

    out = out.cpu()
    print(f"device: {args.device}")
    print(f"generated {out.shape[1]} tokens for {out.shape[0]} sequences")
    print("first sequence:", out[0].tolist())
    print(f"continued after restore: {torch.equal(resumed.cpu(), out)}")
    assert out.shape == (BATCH, NEW_TOKENS)
    assert bool((out >= 0).all()) and bool((out < cfg.vocab_size).all())
    assert torch.equal(resumed.cpu(), out), "restored session diverged"
    print("OK")


if __name__ == "__main__":
    main()
