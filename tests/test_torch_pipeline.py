"""The port's data path on the CPU against the reference: ``dataframe.tensor``
(``to_matrix``, ``to_token_batches``), ``data.pipeline`` (the corpus, the
content hash, ``preprocess_local`` and ``preprocess_distributed``) and the
training loop's ``data_iter`` (``launch.train``).  Everything here is integer or routing
output, so everything is exact: the same token batches and masks, the same
``PipelineStats``, the same ``keep_ids``, and modeled comm seconds equal to
the last bit.
"""

import numpy as np
import pytest
import torch

from repro.core.communicator import make_communicator as j_make_comm
from repro.data import pipeline as jpipe
from repro.dataframe import table as j_table
from repro.dataframe import tensor as jtensor
from repro.launch import train as jtrain
from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.core import make_communicator as t_make_comm
from repro_torch.data import pipeline as tpipe
from repro_torch.dataframe import tensor as ttensor
from repro_torch.interop import table_from_numpy
from repro_torch.launch import train as ttrain


def _tables(n, cap, seed):
    rng = np.random.default_rng(seed)
    cols = {"tok": rng.integers(1, 1000, n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32)}
    jt = j_table.Table.from_dict(cols, capacity=cap)
    tt = table_from_numpy({k: np.asarray(v) for k, v in jt.columns.items()}, int(jt.count), "cpu")
    return jt, tt


@pytest.mark.parametrize("n,cap,batch,seq,nb", [
    (100, 128, 2, 16, 1),       # truncate to one batch
    (100, 128, 2, 16, None),    # every full batch
    (20, 24, 2, 16, 1),         # pad past the capacity
    (0, 8, 1, 4, None),         # empty: one padded batch
])
def test_to_token_batches_matches(n, cap, batch, seq, nb):
    jt, tt = _tables(n, cap, n + cap)
    jtok, jmask = jtensor.to_token_batches(jt, "tok", batch, seq, nbatches=nb)
    ttok, tmask = ttensor.to_token_batches(tt, "tok", batch, seq, nbatches=nb)
    assert ttok.dtype == torch.int32 and tmask.dtype == torch.bool
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_to_matrix_matches():
    jt, tt = _tables(50, 64, 3)
    np.testing.assert_array_equal(ttensor.to_matrix(tt, ["tok", "x"]).numpy(),
                                  np.asarray(jtensor.to_matrix(jt, ["tok", "x"])))


def test_corpus_and_content_hash_match():
    j = jpipe.synthesize_corpus(64, 12, 300, seed=5)
    t = tpipe.synthesize_corpus(64, 12, 300, seed=5)
    for a, b in zip((j[0], j[1], j[2]["doc_id"], j[2]["quality"]),
                    (t[0], t[1], t[2]["doc_id"], t[2]["quality"])):
        np.testing.assert_array_equal(a, b)
    exp = jpipe._content_hash(j[1])
    got = tpipe._content_hash(torch.from_numpy(t[1]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("batch,seq_len", [(4, 64), (2, 16)])
def test_preprocess_local_matches(batch, seq_len):
    corpus = jpipe.synthesize_corpus(512, seq_len, 512, seed=1)
    (jtok, jmask), jstats = jpipe.preprocess_local(*corpus, batch=batch, seq_len=seq_len)
    (ttok, tmask), tstats = tpipe.preprocess_local(*corpus, batch=batch, seq_len=seq_len,
                                                   device="cpu")
    assert tstats.__dict__ == jstats.__dict__
    assert jstats.docs_after_dedupe < jstats.docs_kept < jstats.docs_in  # each stage acts
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("world,env", [(4, "direct"), (2, "redis")])
def test_preprocess_distributed_matches(world, env):
    corpus = jpipe.synthesize_corpus(256, 8, 100, seed=2)
    jkeep, jtime = jpipe.preprocess_distributed(*corpus, j_make_comm(world, env))
    tkeep, ttime = tpipe.preprocess_distributed(*corpus, t_make_comm(world, env), device="cpu")
    np.testing.assert_array_equal(tkeep, jkeep)
    assert ttime == jtime > 0


def test_data_iter_matches_across_shards_and_resume():
    """The same slices as the reference's, from a fresh start and from a
    resume point on either side of a corpus-shard boundary."""
    jcfg = jconfigs.get("minicpm-2b").reduced()
    tcfg = tconfigs.get("minicpm-2b").reduced()
    batch, seq_len = 8, 32
    (toks, _), _ = ttrain.build_dataset(tcfg, batch, seq_len, device="cpu")
    per_shard = toks.shape[0] // batch
    for start, n in ((0, 3), (per_shard - 1, 3)):
        jit = jtrain.data_iter(jcfg, batch, seq_len, start=start)
        tit = ttrain.data_iter(tcfg, batch, seq_len, start=start, device="cpu")
        for _ in range(n):
            jb, tb = next(jit), next(tit)
            assert tb["mask"].dtype == torch.float32
            np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
            np.testing.assert_array_equal(tb["mask"].numpy(),
                                          np.asarray(jb["mask"], np.float32))
