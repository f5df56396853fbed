#!/usr/bin/env python3
"""How fast the XTR token encoder learns at full width, on one card.

    python3 scripts/encoder_train_curves.py [--steps 40] [--seed 16]

Trains ``EncoderConfig()`` (12 layers, d 768, float32, TF32 off) from the
same random weights with ``examples/train_encoder_torch.py``'s in-batch
objective on its ``make_batch`` batches at ``chip_smoke.py``'s
``encoder_train`` shape (128 queries of 32 tokens, documents of 192), at
three AdamW settings: the example's (lr 3e-3 after 20 warmup steps), lr
1e-3 and lr 3e-4 without warmup. Prints each step's loss and, before
training and every 10 steps, success@5 of 128 sub-sequence queries over
a corpus of 4,096 such documents by exact MaxSim
(``core.maxsim_bruteforce``: every query token against every document
token, no index), the ``encoder_train`` phase's corpus at ``--seed 16``
(its seed at ``chip_smoke.py --seed 0``). One line of JSON per setting.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import chip_smoke as cs  # noqa: E402

CHUNK = 256  # documents per encode call


def exact_success(model, corpus: dict, n_queries: int, k: int = 5) -> float:
    """success@k of the corpus's first ``n_queries`` queries (query i's
    document is doc i) by ``maxsim_bruteforce`` over every document."""
    from repro_torch.core import maxsim_bruteforce

    d_tok, q_tok = corpus["d_tok"], corpus["q_tok"][:n_queries]
    n_docs, dev = d_tok.shape[0], d_tok.device
    mask = torch.ones(CHUNK, d_tok.shape[1], dtype=torch.bool, device=dev)
    emb = torch.cat([model.encode(d_tok[lo: lo + CHUNK], mask) for lo in range(0, n_docs, CHUNK)])
    emb = emb.reshape(-1, emb.shape[-1])
    doc_ids = torch.arange(n_docs, device=dev).repeat_interleave(d_tok.shape[1])
    qmask = torch.ones(q_tok.shape, dtype=torch.bool, device=dev)
    q = model.encode(q_tok, qmask)
    hits = [i in maxsim_bruteforce(q[i], qmask[i], emb, doc_ids, n_docs=n_docs, k=k,
                                   device=dev).doc_ids.tolist() for i in range(n_queries)]
    return float(np.mean(hits))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=16, help="weights and corpus seed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("encoder_train_curves: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.families import encoder_loss_fn
    from repro_torch.models import EncoderConfig, TokenEncoder, init_params
    from repro_torch.train import AdamWConfig, TrainState, make_train_step

    ex = cs.load_example("train_encoder_torch")
    cfg = EncoderConfig()
    dev = torch.device("cuda")

    def draw(step: int, batch: int) -> dict:
        b = ex.make_batch(step, cfg=cfg, doc_len=cs.ENC_DOC_LEN, q_len=cfg.query_maxlen, batch=batch)
        return {k: v.to(dev) for k, v in b.items()}

    corpus = draw(cs.ENC_CORPUS_SEED + args.seed, cs.ENC_CORPUS_DOCS)
    batches = [draw(s, cs.ENC_BATCH) for s in range(args.steps)]
    settings = {
        "example": AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        "lr1e-3": AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=args.steps),
        "lr3e-4": AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=args.steps),
    }
    print(cs.card(), flush=True)
    for name, opt in settings.items():
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(args.seed)
        state = TrainState.create(init_params(cfg, g, device=dev))
        step = make_train_step(encoder_loss_fn(cfg, ex.xtr_inbatch_loss), opt)
        success = {0: exact_success(TokenEncoder.from_params(cfg, state.params), corpus,
                                    cs.ENC_QUERIES)}
        losses = []
        for s in range(args.steps):
            state, m = step(state, batches[s])
            losses.append(float(m["loss"]))
            if (s + 1) % 10 == 0:
                success[s + 1] = exact_success(TokenEncoder.from_params(cfg, state.params), corpus,
                                               cs.ENC_QUERIES)
        print(name, json.dumps({"losses": losses, "success@5": success,
                                "s": round(time.perf_counter() - t0, 1)}), flush=True)
        del state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
