"""End-to-end training driver of the PyTorch port: train a small token
encoder with the XTR in-batch objective for a few hundred steps, with
checkpoint/auto-resume, then build a WARP index from the trained encoder
and verify retrieval improves over the untrained encoder. The port of
``examples/train_encoder.py``, function by function; it imports torch,
numpy and ``repro_torch`` only.

  PYTHONPATH=src python examples/train_encoder_torch.py [--steps 200] [--device cpu]

It runs on the card unless ``--device`` names another device; with no
card and no ``--device`` it raises (there is no fallback).
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.families import encoder_loss_fn
from repro_torch.core import IndexBuildConfig, WarpSearchConfig, build_index, resolve_device, search
from repro_torch.models import EncoderConfig, TokenEncoder, init_params
from repro_torch.train import AdamWConfig, train_loop

CFG = EncoderConfig(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512, out_dim=32)
DOC_LEN, Q_LEN, BATCH = 12, 6, 16


def xtr_inbatch_loss(params_or_model, batch):
    """XTR training objective: in-batch cross-entropy over sum-of-MaxSim
    scores between each query and every document in the batch. Takes a
    ``TokenEncoder`` or a state dict of ``CFG``'s (``encoder_loss_fn``
    builds the module once per params dict for ``make_train_step``)."""
    model = params_or_model
    if not isinstance(model, TokenEncoder):
        model = TokenEncoder.from_params(CFG, params_or_model, trainable=True)
    q_emb = model(batch["q_tok"], batch["q_mask"])
    d_emb = model(batch["d_tok"], batch["d_mask"])
    # scores[i, j] = sum_t max_s <q_emb[i, t], d_emb[j, s]>
    sim = torch.einsum("iqd,jsd->ijqs", q_emb, d_emb)
    d_mask = torch.as_tensor(batch["d_mask"], device=sim.device)
    q_mask = torch.as_tensor(batch["q_mask"], device=sim.device)
    # -1e30, not -inf: a document with every token masked stays finite.
    sim = torch.where(d_mask[None, :, None, :] > 0, sim, -1e30)
    maxsim = torch.amax(sim, dim=-1)  # [B, B, Q]; ties share the gradient, as jnp.max's
    scores = torch.sum(maxsim * q_mask[:, None, :], dim=-1)  # [B, B]
    labels = torch.arange(scores.shape[0], device=scores.device)
    logp = torch.log_softmax(scores, dim=-1)
    loss = -torch.mean(torch.take_along_dim(logp, labels[:, None], dim=-1))
    return loss, {"xtr_ce": loss}


def make_batch(step: int, *, cfg=None, doc_len=None, q_len=None, batch=None):
    """The batch of ``step``, drawn as the JAX example draws it (the same
    numbers): ``CFG``, ``DOC_LEN``, ``Q_LEN`` and ``BATCH`` by default."""
    cfg = CFG if cfg is None else cfg
    doc_len = DOC_LEN if doc_len is None else doc_len
    q_len = Q_LEN if q_len is None else q_len
    batch = BATCH if batch is None else batch
    rng = np.random.default_rng(step)
    d_tok = rng.integers(0, cfg.vocab, (batch, doc_len))
    # queries are noisy sub-sequences of their positive document
    starts = rng.integers(0, doc_len - q_len, batch)
    q_tok = np.stack([d_tok[i, s : s + q_len] for i, s in enumerate(starts)])
    flip = rng.random((batch, q_len)) < 0.1
    q_tok = np.where(flip, rng.integers(0, cfg.vocab, (batch, q_len)), q_tok)
    return {
        "q_tok": torch.from_numpy(q_tok.astype(np.int32)),
        "q_mask": torch.ones((batch, q_len), dtype=torch.float32),
        "d_tok": torch.from_numpy(d_tok.astype(np.int32)),
        "d_mask": torch.ones((batch, doc_len), dtype=torch.float32),
    }


def retrieval_success(params, n_docs=64, k=5, seed=123) -> float:
    """success@k of 16 sub-sequence queries over an index of ``n_docs``
    documents built on the parameters' device."""
    model = TokenEncoder.from_params(CFG, params)
    rng = np.random.default_rng(seed)
    d_tok = rng.integers(0, CFG.vocab, (n_docs, DOC_LEN))
    d_emb = model.encode(torch.from_numpy(d_tok), torch.ones((n_docs, DOC_LEN)))
    emb = d_emb.reshape(-1, CFG.out_dim)
    ids = np.repeat(np.arange(n_docs, dtype=np.int32), DOC_LEN)
    index = build_index(emb, ids, n_docs, IndexBuildConfig(n_centroids=16, kmeans_iters=3),
                        device=model.device)
    hits = 0
    for i in range(16):
        q_tok = d_tok[i, 2 : 2 + Q_LEN]
        q_emb = model.encode(torch.from_numpy(q_tok)[None], torch.ones((1, Q_LEN)))[0]
        res = search(index, q_emb, torch.ones((Q_LEN,), dtype=torch.bool),
                     WarpSearchConfig(nprobe=8, k=k))
        hits += int(i in res.doc_ids.cpu().numpy())
    return hits / 16


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device to train and retrieve on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    init = lambda: init_params(CFG, torch.Generator(device=dev).manual_seed(0), device=dev)  # noqa: E731
    base_succ = retrieval_success(init())
    print(f"untrained encoder success@5: {base_succ:.2f}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, hist = train_loop(
            init_params_fn=init,
            loss_fn=encoder_loss_fn(CFG, xtr_inbatch_loss),
            batch_iter=make_batch,
            opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
            n_steps=args.steps,
            ckpt_dir=ckpt_dir,
            ckpt_every=50,
            log_every=25,
            device=dev,
        )
    trained_succ = retrieval_success(state.params)
    print(f"trained encoder success@5: {trained_succ:.2f} (loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f})")
    assert trained_succ >= base_succ, "training should not hurt retrieval"


if __name__ == "__main__":
    main()
