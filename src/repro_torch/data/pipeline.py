"""Preprocessing pipeline: the paper's workload feeding the training loop —
the port of ``repro.data.pipeline``.

Stages: load documents into the DDMF, join them with their metadata on
``doc_id``, filter by quality, dedupe by content hash (groupby, keep the min
doc_id), and pack the surviving tokens into fixed [batch, seq] training
batches.  On the card the content hash runs through the ``hash_partition``
kernel (``hash32``), the join through ``join_probe`` (``join_unique``), and
the dedupe through ``groupby_agg``.  ``synthesize_corpus`` is numpy, equal
to the reference's for a seed; every result (batches, stats, ``keep_ids``,
modeled comm seconds) equals the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.communicator import Communicator
from repro_torch.dataframe import Table, ops_dist, ops_local, tensor
from repro_torch.dataframe.partition import hash32
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PipelineStats:
    docs_in: int
    docs_joined: int
    docs_kept: int
    docs_after_dedupe: int
    batches: int


def synthesize_corpus(ndocs: int, doc_len: int, vocab: int, seed: int = 0,
                      dup_frac: float = 0.2):
    """Synthetic corpus with duplicate documents + metadata table."""
    rng = np.random.default_rng(seed)
    n_unique = max(1, int(ndocs * (1 - dup_frac)))
    base = rng.integers(1, vocab, (n_unique, doc_len)).astype(np.int32)
    idx = np.concatenate([np.arange(n_unique),
                          rng.integers(0, n_unique, ndocs - n_unique)])
    rng.shuffle(idx)
    docs = base[idx]
    doc_ids = np.arange(ndocs, dtype=np.int32)
    meta = {
        "doc_id": doc_ids.copy(),
        "quality": rng.uniform(0, 1, ndocs).astype(np.float32),
    }
    return doc_ids, docs, meta


def _content_hash(docs: torch.Tensor) -> torch.Tensor:
    """[ndocs] int32 content hash of [ndocs, doc_len] int32 token rows:
    h = hash32(h) ^ column, over the columns, then the sign bit cleared.
    h stays on the docs' device (uint32 bits held as int32)."""
    h = torch.zeros(docs.shape[0], dtype=torch.int32, device=docs.device)
    for j in range(docs.shape[1]):
        h = hash32(h).view(torch.int32) ^ docs[:, j]
    return h & 0x7FFFFFFF


def _doc_tables(doc_ids, content, meta, sl, capacity, device):
    dtab = Table.from_dict({"doc_id": doc_ids[sl], "content": content[sl]},
                           capacity=capacity, device=device)
    mtab = Table.from_dict(
        {"doc_id": meta["doc_id"][sl],
         "quality_pm": (meta["quality"][sl] * 1000).astype(np.int32)},
        capacity=capacity, device=device,
    )
    return dtab, mtab


def preprocess_local(
    doc_ids, docs, meta, *, quality_min: float = 0.25,
    batch: int = 4, seq_len: int = 64, device=None,
):
    """Single-table pipeline on ``device`` (default: the card); returns
    ((tokens [n, seq_len] int32, mask bool), stats)."""
    dev = resolve_device(device)
    ndocs, doc_len = docs.shape
    content = _content_hash(torch.from_numpy(np.ascontiguousarray(docs, np.int32)).to(dev))
    dtab, mtab = _doc_tables(doc_ids, content, meta, slice(None), ndocs + 8, dev)
    joined = ops_local.join_unique(dtab, mtab, "doc_id")
    kept = joined.filter(joined.columns["quality_pm"] >= int(quality_min * 1000))
    # dedupe: groupby content hash, keep min doc_id
    rep = ops_local.groupby_agg(kept, "content", {"doc_id": "min"})
    keep_ids = np.sort(rep.to_numpy()["doc_id_min"])
    sel = np.isin(np.asarray(doc_ids), keep_ids)
    tokens = docs[sel].reshape(-1)
    ttab = Table.from_dict({"tok": tokens}, device=dev)
    toks, mask = tensor.to_token_batches(ttab, "tok", batch, seq_len, nbatches=None)
    nbatches = tokens.size // (batch * seq_len)
    stats = PipelineStats(ndocs, int(joined.count), int(kept.count),
                          int(rep.count), max(nbatches, 1))
    return (toks, mask), stats


def preprocess_distributed(
    doc_ids, docs, meta, comm: Communicator, *, quality_min: float = 0.25, device=None,
):
    """Per-rank pipeline through the communicator (the BSP surface): the
    sorted ``keep_ids`` and the modeled comm seconds."""
    dev = resolve_device(device)
    world = comm.world_size
    ndocs = docs.shape[0]
    per = ndocs // world
    content = _content_hash(torch.from_numpy(np.ascontiguousarray(docs, np.int32)).to(dev))
    dshards, mshards = [], []
    for r in range(world):
        dtab, mtab = _doc_tables(doc_ids, content, meta, slice(r * per, (r + 1) * per),
                                 per * 2, dev)
        dshards.append(dtab)
        mshards.append(mtab)
    joined = ops_dist.sim_join(dshards, mshards, "doc_id", comm)
    kept = [t.filter(t.columns["quality_pm"] >= int(quality_min * 1000)) for t in joined]
    deduped = ops_dist.sim_groupby(kept, "content", {"doc_id": "min"}, comm)
    keep_ids = np.sort(np.concatenate([t.to_numpy()["doc_id_min"] for t in deduped]))
    return keep_ids, comm.comm_time_s
