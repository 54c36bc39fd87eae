"""Related-KG-queries, end to end on PyTorch — the paper's flagship
scenario, including the model layer: a small LM is TRAINED
(examples/torch_train_lm.py's step inline, fewer steps), entity embeddings
are pooled from its hidden states, HQI indexes them against a Table-1-style
template workload, and the batch is served with the full pipeline (routing
-> bitmap pushdown -> batched matmul top-k). Compares HQI vs PreFilter on
time and tuples scanned.

    PYTHONPATH=src python examples/torch_related_queries.py [--device cpu]

The port's version of ``examples/related_queries.py`` (on the card unless
``--device cpu``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import (
    Column, Contains, HQIConfig, HQIIndex, NotNull, PreFilterIndex,
    VectorDatabase, Workload, exhaustive_search, make_filter, recall_at_k,
    tune_nprobe,
)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.transformer import lm_hidden_embed
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- 1. train a small LM (the embedding producer) -------------------------
    cfg = get_reduced("minicpm-2b")
    tcfg = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=40))
    params, opt_state = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(cfg, tcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    for s in range(40):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
        params, opt_state, m = step(params, opt_state, batch)
    print(f"LM trained 40 steps; final loss {float(m['loss']):.3f}")

    # --- 2. embed "entities" (token sequences) with the trained model ---------
    rng = np.random.default_rng(0)
    n_entities, n_types = 4_000, 5
    type_of = rng.integers(0, n_types, n_entities)
    # entities of a type share a token motif -> embeddings correlate with type
    motifs = rng.integers(2, cfg.vocab, size=(n_types, 16))
    seqs = np.tile(motifs[type_of], 1)
    seqs[:, 8:] = rng.integers(2, cfg.vocab, size=(n_entities, 8))
    vecs = []
    for s in range(0, n_entities, 256):
        toks = torch.from_numpy(seqs[s: s + 256].astype(np.int32)).to(dev)
        vecs.append(lm_hidden_embed(params, cfg, toks).cpu().numpy())
    vectors = np.concatenate(vecs).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-6

    # --- 3. attributes + the hybrid query workload -----------------------------
    membership = np.zeros((n_entities, n_types), dtype=bool)
    membership[np.arange(n_entities), type_of] = True
    height = Column.numeric(
        "height", rng.random(n_entities), null_mask=(type_of != 0) | (rng.random(n_entities) < 0.1)
    )
    db = VectorDatabase(
        vectors=vectors,
        columns={"type": Column.setcat("type", membership), "height": height},
        metric="ip",
    )
    templates = [
        make_filter(Contains("type", 0), NotNull("height")),  # "How tall is <Person>?"
        make_filter(Contains("type", 1)),
        make_filter(NotNull("height")),
    ]
    m_q = 600
    t_of = rng.choice(3, size=m_q, p=[0.6, 0.3, 0.1]).astype(np.int32)
    q_ent = rng.integers(0, n_entities, m_q)
    workload = Workload(vectors=vectors[q_ent], templates=templates, template_of=t_of, k=10)

    # --- 4. index + batch serve -------------------------------------------------
    truth = exhaustive_search(db, workload, device=dev)
    hqi = HQIIndex.build(db, workload, HQIConfig(min_partition_size=256, max_leaves=32), device=dev)
    pre = PreFilterIndex.build(db, device=dev)
    np_h = tune_nprobe(lambda w, np_: hqi.search(w, nprobe=np_), workload, truth)
    np_p = tune_nprobe(lambda w, np_: pre.search(w, nprobe=np_), workload, truth)

    t0 = time.perf_counter(); res_h = hqi.search(workload, nprobe=np_h); t_h = time.perf_counter() - t0
    t0 = time.perf_counter(); res_p = pre.search(workload, nprobe=np_p); t_p = time.perf_counter() - t0
    print(f"HQI:       {t_h*1e3:7.1f} ms  recall={recall_at_k(res_h, truth):.2f} "
          f"tuples={res_h.tuples_scanned:,}")
    print(f"PreFilter: {t_p*1e3:7.1f} ms  recall={recall_at_k(res_p, truth):.2f} "
          f"tuples={res_p.tuples_scanned:,}")
    print(f"scan reduction: {1 - res_h.tuples_scanned / max(res_p.tuples_scanned,1):.0%}")
    assert recall_at_k(res_h, truth) >= 0.8
    print("OK")


if __name__ == "__main__":
    main()
