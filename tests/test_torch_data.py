"""Port parity for the host input pipeline: the wire format, the native
reader and writer and the Python parser against the JAX package, bit for
bit; ``batches``, ``eval_batches``, ``stream_batches`` and
``stream_eval_batches`` batch for batch equal to JAX's for the same seed;
and the four reference faults the port does not carry (a batch larger than
the shuffle buffer, a cache identity blind to vocabulary content, shared
chunk temp names, a silent switch to the Python parser), each shown beside
what the JAX package does."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from recalgorithm_tpu.data import pipeline as jpipeline
from recalgorithm_tpu.data import tfrecord as jtfrecord
from recalgorithm_tpu.features.schema import wechat_schema as jwechat_schema
from recalgorithm_tpu.features.vocab import VocabularyStore as JVocabularyStore
from recalgorithm_tpu.runtime import loader as jloader
from recalgorithm_tpu_torch.data import pipeline, tfrecord
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore
from recalgorithm_tpu_torch.runtime import loader
from tests.torch_data_common import VOCAB_TOKENS, ensure_jax_native, write_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 47


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """(path, port vocabs + schema, JAX vocabs + schema) of a 47-row split."""
    root = tmp_path_factory.mktemp("split")
    path, vocab_dir = write_split(root, N, seed=1)
    ensure_jax_native()
    vocabs = VocabularyStore.from_dir(vocab_dir)
    jvocabs = JVocabularyStore.from_dir(vocab_dir)
    return (path, vocabs, wechat_schema(vocabs.sizes()), jvocabs,
            jwechat_schema(jvocabs.sizes()))


def assert_arrays_equal(got, want):
    assert got.dense.dtype == want.dense.dtype and got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(got.dense, want.dense)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.categorical.keys() == want.categorical.keys()
    for k in want.categorical:
        np.testing.assert_array_equal(got.categorical[k], want.categorical[k])
    assert got.sequences.keys() == want.sequences.keys()
    for k, (ids, lens) in want.sequences.items():
        np.testing.assert_array_equal(got.sequences[k][0], ids)
        np.testing.assert_array_equal(got.sequences[k][1], lens)


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _examples():
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        context = {"f": ("float", [float(x) for x in rng.normal(size=i % 3 + 1)]),
                   "b": ("bytes", [b"", "tok_é".encode(), b"x" * 300][: i % 4]),
                   "i": ("int64", [int(x) for x in rng.integers(0, 2**40, size=i)])}
        fl = {"s": ("bytes", [f"t{j}".encode() for j in range(i * 7)]),
              "e": ("bytes", [])}
        out.append((context, fl))
    return out


def test_wire_format_matches_jax(tmp_path):
    """The same dicts encode to the same bytes; each package parses the
    other's bytes to the same dicts; record files frame identically."""
    payloads = []
    for context, fl in _examples():
        ours = tfrecord.encode_sequence_example(context, fl)
        assert ours == jtfrecord.encode_sequence_example(context, fl)
        assert tfrecord.parse_sequence_example(ours) == jtfrecord.parse_sequence_example(ours)
        assert tfrecord.parse_example(ours) == jtfrecord.parse_example(ours)
        for kind, vals in context.values():
            assert tfrecord.encode_feature(kind, vals) == jtfrecord.encode_feature(kind, vals)
        payloads.append(ours)
    tfrecord.write_records(str(tmp_path / "a"), payloads)
    jtfrecord.write_records(str(tmp_path / "b"), payloads)
    assert filecmp.cmp(tmp_path / "a", tmp_path / "b", shallow=False)
    assert list(tfrecord.read_records(str(tmp_path / "b"))) == payloads
    assert tfrecord._masked_crc(payloads[3]) == jtfrecord._masked_crc(payloads[3])


# ---------------------------------------------------------------------------
# readers and writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip,limit", [(0, None), (5, 17), (40, 100)])
def test_readers_match_jax(split, skip, limit):
    """Native reader == JAX's read_dataset; the Python parser == JAX's
    load_tfrecord_dataset; and both of the port's readers agree."""
    path, vocabs, schema, jvocabs, jschema = split
    native = loader.read_dataset(path, schema, vocabs, limit=limit, skip=skip)
    assert native.num_examples == min(N - skip, limit or N)
    assert_arrays_equal(native, jloader.read_dataset(path, jschema, jvocabs, limit=limit,
                                                     skip=skip))
    py = pipeline.load_dataset(path, schema, vocabs, limit=limit, skip=skip,
                               prefer_native=False)
    assert_arrays_equal(py, jpipeline.load_tfrecord_dataset(path, jschema, jvocabs,
                                                            limit=limit, skip=skip))
    assert_arrays_equal(py, native)


def test_native_reader_resumes_from_byte_offset(split):
    """Chunked reads carrying the end offset give the whole-file arrays."""
    path, vocabs, schema, *_ = split
    whole = loader.read_dataset(path, schema, vocabs)
    parts, offset = [], -1
    while True:
        box = []
        part = loader.read_dataset(path, schema, vocabs, limit=10, start_offset=offset,
                                   end_offset_box=box)
        if part.num_examples == 0:
            break
        parts.append(part)
        offset = box[0]
    assert sum(p.num_examples for p in parts) == N
    for k, v in whole.as_flat().items():
        np.testing.assert_array_equal(np.concatenate([p.as_flat()[k] for p in parts]), v)


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    labels = rng.integers(0, 2, size=(n, 2)).astype(np.float32)
    cats = [[b"" if rng.random() < 0.2 else f"c{c}_{rng.integers(9)}".encode()
             for _ in range(n)] for c in range(2)]
    seqs = [[[f"s{c}_{rng.integers(9)}".encode() for _ in range(rng.integers(0, 6))]
             for _ in range(n)] for c in range(2)]
    return dense, cats, labels, seqs


def test_native_writer_matches_jax_and_the_encoder(tmp_path, monkeypatch):
    """Byte-identical to JAX's native writer and to the Python encoder in
    the (dense, categorical, labels) order, across chunks and appends."""
    ensure_jax_native()
    names = (["d0", "d1", "d2"], ["c0", "c1"], ["l0", "l1"], ["s0", "s1"])
    a, b = _columns(11, 0), _columns(6, 1)

    def write(writer, out):
        for i, (dense, cats, labels, seqs) in enumerate((a, b)):
            rows = writer(str(out), names[0], dense, names[1], cats, names[2], labels,
                          names[3], seqs, append=i > 0)
            assert rows == len(dense)

    monkeypatch.setattr(loader, "CHUNK_ROWS", 4)  # several chunks a call
    write(loader.write_sequence_examples, tmp_path / "port")
    write(jloader.write_sequence_examples, tmp_path / "jax")
    payloads = []
    for dense, cats, labels, seqs in (a, b):
        for r in range(len(dense)):
            context = {n: ("float", [float(dense[r, i])]) for i, n in enumerate(names[0])}
            context.update({n: ("bytes", [cats[i][r]]) for i, n in enumerate(names[1])})
            context.update({n: ("float", [float(labels[r, i])]) for i, n in enumerate(names[2])})
            fl = {n: ("bytes", seqs[i][r]) for i, n in enumerate(names[3])}
            payloads.append(tfrecord.encode_sequence_example(context, fl))
    tfrecord.write_records(str(tmp_path / "python"), payloads)
    assert filecmp.cmp(tmp_path / "port", tmp_path / "jax", shallow=False)
    assert filecmp.cmp(tmp_path / "port", tmp_path / "python", shallow=False)
    with pytest.raises(ValueError, match="has 10 rows"):
        loader.write_sequence_examples(str(tmp_path / "bad"), names[0], a[0], names[1],
                                       [a[1][0], a[1][1][:10]], names[2], a[2], [], [])


def test_concurrent_builds_are_safe(tmp_path):
    """Four processes building into an empty build directory at once all
    load a whole library, and leave one file behind."""
    code = ("import sys; from pathlib import Path; "
            "from recalgorithm_tpu_torch.runtime import loader; "
            "loader.BUILD = Path(sys.argv[1]); "
            "lib = loader._library('tfrecord_writer'); print(lib.write_sequence_examples)")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


# ---------------------------------------------------------------------------
# batch streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,drop_remainder", [(True, False), (True, True), (False, False)])
def test_batches_match_jax(split, shuffle, drop_remainder):
    path, vocabs, schema, jvocabs, jschema = split
    data = pipeline.load_dataset(path, schema, vocabs)
    jdata = jpipeline.load_dataset(path, jschema, jvocabs)
    kw = dict(num_epochs=3, shuffle=shuffle, seed=7, drop_remainder=drop_remainder, max_steps=10)
    assert_batches_equal(pipeline.batches(data, 8, **kw), jpipeline.batches(jdata, 8, **kw))


@pytest.mark.parametrize("num_batches,index_offset", [(None, 0), (9, 100)])
def test_eval_batches_match_jax(split, num_batches, index_offset):
    path, vocabs, schema, jvocabs, jschema = split
    data = pipeline.load_dataset(path, schema, vocabs)
    jdata = jpipeline.load_dataset(path, jschema, jvocabs)
    got = list(pipeline.eval_batches(data, 8, num_batches=num_batches, index_offset=index_offset))
    assert_batches_equal(got, jpipeline.eval_batches(jdata, 8, num_batches=num_batches,
                                                     index_offset=index_offset))
    assert len(got) == (num_batches or 6)
    idx = np.concatenate([b["_index"][b["_weights"] > 0] for b in got])
    np.testing.assert_array_equal(idx, index_offset + np.arange(N))
    assert_batches_equal([pipeline.zero_batch(schema, 8)], [jpipeline.zero_batch(jschema, 8)])


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("batch_size,buffer,drop_remainder", [(4, 8, False), (8, 8, True)])
def test_stream_batches_match_jax(split, tmp_path, monkeypatch, cached, batch_size, buffer,
                                  drop_remainder):
    """Batch size at or under the buffer: the port's stream is JAX's, batch
    for batch, across two epochs; with the cache, a second run makes no raw
    read and serves the same batches."""
    path, vocabs, schema, jvocabs, jschema = split
    kw = dict(num_epochs=2, shuffle_buffer_size=buffer, seed=3, chunk_records=10,
              drop_remainder=drop_remainder)
    want = list(jpipeline.stream_batches(path, jschema, jvocabs, batch_size, **kw))
    cache = str(tmp_path / "cache") if cached else None
    assert_batches_equal(pipeline.stream_batches(path, schema, vocabs, batch_size,
                                                 cache_dir=cache, **kw), want)
    if cached:
        reads = []
        real = pipeline.load_dataset
        monkeypatch.setattr(pipeline, "load_dataset",
                            lambda *a, **k: reads.append(1) or real(*a, **k))
        assert_batches_equal(pipeline.stream_batches(path, schema, vocabs, batch_size,
                                                     cache_dir=cache, **kw), want)
        assert not reads


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_stream_eval_batches_match_jax(split, tmp_path, host_index, host_count):
    path, vocabs, schema, jvocabs, jschema = split
    kw = dict(chunk_records=10, host_index=host_index, host_count=host_count)
    want = list(jpipeline.stream_eval_batches(path, jschema, jvocabs, 8, **kw))
    for cache in (None, str(tmp_path / "c"), str(tmp_path / "c")):
        assert_batches_equal(
            pipeline.stream_eval_batches(path, schema, vocabs, 8, cache_dir=cache, **kw), want)


# ---------------------------------------------------------------------------
# the reference faults the port does not carry
# ---------------------------------------------------------------------------

def test_stream_batch_larger_than_buffer(split):
    """JAX's swap-refill pool draws batch_size distinct slots from
    shuffle_buffer_size and raises; the port's pool holds max(buffer,
    batch) rows and serves every row once an epoch."""
    path, vocabs, schema, jvocabs, jschema = split
    with pytest.raises(ValueError):
        list(jpipeline.stream_batches(path, jschema, jvocabs, 16, shuffle_buffer_size=5,
                                      chunk_records=10))
    got = list(pipeline.stream_batches(path, schema, vocabs, 16, shuffle_buffer_size=5,
                                       chunk_records=10, drop_remainder=False))
    assert [len(b["labels"]) for b in got] == [16, 16, 16]
    rows = np.concatenate([b["dense"][b.get("_weights", np.ones(16)) > 0] for b in got])
    want = pipeline.load_dataset(path, schema, vocabs).dense
    np.testing.assert_array_equal(rows[np.lexsort(rows.T)], want[np.lexsort(want.T)])


def test_cache_identity_covers_vocabulary_content(tmp_path):
    """A vocabulary rewritten with the same sizes in another order: JAX's
    cache still serves the old translation; the port's re-reads."""
    ensure_jax_native()
    path, vocab_dir = write_split(tmp_path, 23, seed=2)

    def run(pkg, store, schema_fn):
        vocabs = store.from_dir(vocab_dir)
        return list(pkg.stream_eval_batches(path, schema_fn(vocabs.sizes()), vocabs, 8,
                                            chunk_records=5, cache_dir=str(tmp_path / pkg.__name__)))

    for pkg, store, schema_fn in ((pipeline, VocabularyStore, wechat_schema),
                                  (jpipeline, JVocabularyStore, jwechat_schema)):
        with open(os.path.join(vocab_dir, "feedid.txt"), "w") as f:
            f.write("\n".join(VOCAB_TOKENS["feedid"]) + "\n")
        first = run(pkg, store, schema_fn)
        with open(os.path.join(vocab_dir, "feedid.txt"), "w") as f:
            f.write("\n".join(reversed(VOCAB_TOKENS["feedid"])) + "\n")
        second = run(pkg, store, schema_fn)
        vocabs = store.from_dir(vocab_dir)
        fresh = pkg.load_dataset(path, schema_fn(vocabs.sizes()), vocabs).categorical["feedid"]
        served = np.concatenate([b["feedid"][b["_weights"] > 0] for b in second])
        stale = np.concatenate([b["feedid"][b["_weights"] > 0] for b in first])
        assert not np.array_equal(fresh, stale)
        np.testing.assert_array_equal(served, fresh if pkg is pipeline else stale)


def test_chunk_temp_names_are_unique_per_writer(tmp_path, monkeypatch):
    """Two writers of one cache identity: JAX's share one temp name per
    chunk; the port's carry the pid and a uuid."""
    flat = {"labels": np.zeros((3, 1), np.float32)}
    for pkg in (pipeline, jpipeline):
        names = []
        real = os.replace
        monkeypatch.setattr(pkg.os, "replace", lambda src, dst: names.append(src) or real(src, dst))
        for _ in range(2):
            cache = pkg.ChunkCache(str(tmp_path / pkg.__name__), {"k": 1})
            cache.add(flat)
            cache.finish()
        monkeypatch.undo()
        chunk_tmps = [n for n in names if "chunk00000" in n]
        assert len(chunk_tmps) == 2
        if pkg is pipeline:
            assert chunk_tmps[0] != chunk_tmps[1] and f".{os.getpid()}." in chunk_tmps[0]
        else:
            assert chunk_tmps[0] == chunk_tmps[1]


def test_native_failure_raises(split, monkeypatch):
    """With the native library unbuildable, JAX's load_dataset quietly
    parses in Python; the port's load_dataset and shuffle raise, and the
    Python parser runs only on request."""
    path, vocabs, schema, jvocabs, jschema = split

    def broken(*args, **kwargs):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(jloader, "read_dataset", broken)
    assert jpipeline.load_dataset(path, jschema, jvocabs).num_examples == N
    data = pipeline.load_dataset(path, schema, vocabs)
    with pytest.raises(FileNotFoundError):
        pipeline.load_dataset(path + ".missing", schema, vocabs)
    monkeypatch.setattr(loader, "_loaded", {})
    monkeypatch.setattr(loader, "build", broken)
    with pytest.raises(RuntimeError, match="g.. failed"):
        pipeline.load_dataset(path, schema, vocabs)
    with pytest.raises(RuntimeError, match="g.. failed"):
        next(pipeline.batches(data, 8, shuffle=True))
    assert pipeline.load_dataset(path, schema, vocabs, prefer_native=False).num_examples == N


def test_prefetch_passes_items_errors_and_stops():
    def source():
        yield 1
        yield 2
        raise KeyError("boom")

    it = pipeline.prefetch(source())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError):
        next(it)
    endless = pipeline.prefetch(iter(range(10**9)), depth=2)
    assert next(endless) == 0
    endless.close()  # the worker sees the stop and returns
