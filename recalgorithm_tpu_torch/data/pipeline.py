"""Host input pipeline: TFRecords -> translated, fixed-shape numpy batches.

Counterpart of ``recalgorithm_tpu/data/pipeline.py``, with the same RNG
calls, so the same seed gives the same batches in the same order.  It
replaces tf.data's TFRecordDataset -> shuffle(10000) -> repeat -> batch ->
parse -> prefetch(1) chain (reference algorithm/utils.py:18-26):

  * string->id translation happens on the host: categorical tokens are
    mapped through the compiled vocabularies once, at load time, and the
    translated split is held as dense numpy arrays,
  * every batch has identical shapes: sequences are padded to the schema's
    max_length, a padded tail carries a 0/1 ``_weights`` mask,
  * shuffle: a full permutation per epoch, gathered once by the native
    threaded row copy (runtime/loader.permute_rows),
  * a one-deep background prefetch thread overlaps host batch assembly with
    device steps (prefetch(1) parity).

The native reader (runtime/loader.py) parses unless the caller passes
``prefer_native=False``; a failed build or read raises, it never switches to
the Python parser on its own.  Several processes read their own input:
``shard_for_host`` keeps a loaded split's contiguous slice for this
process's data shard, and the streams take ``host_index``/``host_count``.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import uuid
from typing import Iterator, Mapping

import numpy as np

from recalgorithm_tpu_torch.data import tfrecord
from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore
from recalgorithm_tpu_torch.parallel import multihost
from recalgorithm_tpu_torch.runtime import loader
from recalgorithm_tpu_torch.runtime.loader import DatasetArrays


class ChunkCache:
    """On-disk cache of vocab-translated chunk arrays for the --stream paths.

    The streaming modes bound RAM by re-reading the TFRecord split in chunks,
    so every epoch past the first (and every extra eval pass) would re-pay
    parse + vocabulary translation for a result that never changes.  This
    cache spills each chunk's translated arrays to
    ``<dir>/<identity-hash>/chunk<i>.npz`` during the first pass and serves
    later passes with one ``np.load`` per chunk, at one-chunk peak RAM.

    Safety: each chunk is written under a name unique to its writer (pid and
    a uuid) and renamed into place, so writers sharing a directory never
    interleave one file; MANIFEST.json (the chunk count and the identity) is
    written only after the LAST chunk of a complete pass, so a pass that
    stops mid-stream leaves an invalid cache and the next pass re-reads the
    split.  The identity covers the source file (path, size, mtime), the
    chunking parameters, the schema surface, and each vocabulary's size and
    content fingerprint: a vocabulary regenerated with the same sizes
    invalidates the cache.
    """

    def __init__(self, cache_dir: str, identity: dict):
        # a JSON round trip so tuples inside the identity (schema triples)
        # compare equal to the lists MANIFEST.json stores
        self.identity = json.loads(json.dumps(identity))
        key = hashlib.sha256(
            json.dumps(self.identity, sort_keys=True).encode()).hexdigest()[:16]
        self.dir = os.path.join(cache_dir, key)
        self.manifest = os.path.join(self.dir, "MANIFEST.json")
        self._written = 0

    def valid(self) -> bool:
        try:
            with open(self.manifest) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return False
        return m.get("identity") == self.identity and all(
            os.path.exists(self._chunk_path(i)) for i in range(m["num_chunks"]))

    def _chunk_path(self, i: int) -> str:
        return os.path.join(self.dir, f"chunk{i:05d}.npz")

    @staticmethod
    def _tmp(path: str) -> str:
        return f"{path}.{os.getpid()}.{uuid.uuid4().hex}.tmp"

    def add(self, flat: Mapping[str, np.ndarray]) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = self._chunk_path(self._written)
        tmp = self._tmp(path)
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
        self._written += 1

    def finish(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = self._tmp(self.manifest)
        with open(tmp, "w") as f:
            json.dump({"identity": self.identity, "num_chunks": self._written}, f)
        os.replace(tmp, self.manifest)

    def serve(self) -> Iterator[dict[str, np.ndarray]]:
        with open(self.manifest) as f:
            n = json.load(f)["num_chunks"]
        for i in range(n):
            with np.load(self._chunk_path(i), allow_pickle=False) as z:
                yield {k: z[k] for k in z.files}


def _stream_identity(path: str, schema: Schema, vocabs: VocabularyStore, **params) -> dict:
    st = os.stat(path)
    return {
        "path": os.path.abspath(path),
        "size": st.st_size,
        "mtime": st.st_mtime,
        "schema": [(f.name, getattr(f, "max_length", 0), f.vocab)
                   for f in list(schema.categorical) + list(schema.sequence)]
                  + [("dense", 0, d) for d in schema.dense_names]
                  + [("label", 0, l) for l in schema.labels],
        "vocab_sizes": dict(sorted(vocabs.sizes().items())),
        # content hash of each vocabulary's tokens in id order
        "vocab_fingerprints": {
            name: hashlib.sha256("\n".join(vocabs[name].tokens()).encode()).hexdigest()[:16]
            for name in sorted(vocabs.vocabs)},
        **params,
    }


def load_tfrecord_dataset(
    path: str,
    schema: Schema,
    vocabs: VocabularyStore,
    limit: int | None = None,
    skip: int = 0,
) -> DatasetArrays:
    """Parse + translate a reference-format SequenceExample TFRecord file in
    Python (the native reader's oracle)."""
    dense_rows, label_rows = [], []
    cat_rows: dict[str, list[int]] = {f.name: [] for f in schema.categorical}
    seq_rows: dict[str, tuple[list, list]] = {f.name: ([], []) for f in schema.sequence}
    lookups = {f.name: vocabs[f.vocab] for f in (*schema.categorical, *schema.sequence)}

    for n, payload in enumerate(tfrecord.read_records(path)):
        if n < skip:
            continue
        if limit is not None and n - skip >= limit:
            break
        context, feature_lists = tfrecord.parse_sequence_example(payload)
        dense_rows.append([float(context[name][1][0]) if name in context else 0.0
                           for name in schema.dense_names])
        label_rows.append([float(context[name][1][0]) if name in context else 0.0
                           for name in schema.labels])
        for f in schema.categorical:
            _, vals = context.get(f.name, ("bytes", [b""]))
            tok = vals[0].decode("utf-8") if vals else ""
            cat_rows[f.name].append(lookups[f.name].lookup(tok))
        for f in schema.sequence:
            steps = feature_lists.get(f.name, [])
            toks = [v[1][0].decode("utf-8") for v in steps if v[1]][-f.max_length:]
            ids, lens = seq_rows[f.name]
            ids.append([lookups[f.name].lookup(t) for t in toks])
            lens.append(len(toks))

    n = len(dense_rows)
    sequences = {}
    for f in schema.sequence:
        ids, lens = seq_rows[f.name]
        padded = np.zeros((n, f.max_length), np.int32)
        for i, row in enumerate(ids):
            padded[i, : len(row)] = row
        sequences[f.name] = (padded, np.asarray(lens, np.int32))
    return DatasetArrays(
        dense=np.asarray(dense_rows, np.float32).reshape(n, len(schema.dense)),
        categorical={k: np.asarray(v, np.int32) for k, v in cat_rows.items()},
        sequences=sequences,
        labels=np.asarray(label_rows, np.float32).reshape(n, len(schema.labels)),
    )


def shard_for_host(data: DatasetArrays, mesh=None) -> DatasetArrays:
    """This process's contiguous slice of a loaded split (its data shard of
    ``mesh``, else its rank; ``parallel/multihost.host_shard_range``); the
    whole split for one process."""
    if multihost.data_shard(mesh)[1] == 1:
        return data
    start, end = multihost.host_shard_range(data.num_examples, mesh)
    return DatasetArrays(
        dense=data.dense[start:end],
        categorical={f: v[start:end] for f, v in data.categorical.items()},
        sequences={f: (ids[start:end], lens[start:end])
                   for f, (ids, lens) in data.sequences.items()},
        labels=data.labels[start:end])


def load_dataset(
    path: str,
    schema: Schema,
    vocabs: VocabularyStore,
    limit: int | None = None,
    prefer_native: bool = True,
    skip: int = 0,
    start_offset: int = -1,
    end_offset_box: list | None = None,
) -> DatasetArrays:
    """Load through the native reader, or the Python parser when the caller
    passes ``prefer_native=False``.  A failed native build or read raises.

    ``start_offset``/``end_offset_box`` carry a byte position between
    chunked reads (native reader only)."""
    if not prefer_native:
        return load_tfrecord_dataset(path, schema, vocabs, limit=limit, skip=skip)
    return loader.read_dataset(path, schema, vocabs, limit=limit, skip=skip,
                               start_offset=start_offset, end_offset_box=end_offset_box)


def _gather_rows(data: DatasetArrays, order: np.ndarray) -> dict[str, np.ndarray]:
    """Epoch shuffle gather through the native threaded row copy."""
    return {k: loader.permute_rows(v, order) for k, v in data.as_flat().items()}


def _pad_to(batch: Mapping[str, np.ndarray], batch_size: int) -> dict[str, np.ndarray]:
    """Zero-pad every column of a short batch to ``batch_size`` rows."""
    return {k: np.concatenate([v, np.zeros((batch_size - len(v),) + v.shape[1:], v.dtype)])
            for k, v in batch.items()}


def _mask(valid: int, batch_size: int) -> np.ndarray:
    return np.concatenate([np.ones(valid, np.float32),
                           np.zeros(batch_size - valid, np.float32)])


def batches(
    data: DatasetArrays,
    batch_size: int,
    num_epochs: int = 1,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
    max_steps: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-shape batch stream; partial tails are zero-padded with _weights.

    Shuffling permutes the whole dataset once per epoch (one gather pass)
    and then serves contiguous zero-copy views."""
    n = data.num_examples
    steps = 0
    for epoch in range(num_epochs):
        if shuffle:
            order = np.random.default_rng((seed, epoch)).permutation(n)
            flat = _gather_rows(data, order)
        else:
            flat = data.as_flat()
        for start in range(0, n, batch_size):
            end = start + batch_size
            if end > n:
                if drop_remainder:
                    break
                batch = _pad_to({k: v[start:] for k, v in flat.items()}, batch_size)
                batch["_weights"] = _mask(n - start, batch_size)
            else:
                batch = {k: v[start:end] for k, v in flat.items()}
            yield batch
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return


def eval_batches(
    data: DatasetArrays,
    batch_size: int,
    num_batches: int | None = None,
    index_offset: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Order-preserving eval batches with uniform metadata columns.

    Every batch carries ``_weights`` (0/1 real-row mask) and ``_index``
    (global row id = ``index_offset`` + local position; -1 on padding), so
    predictions can be put back in file order.  ``num_batches`` forces the
    batch count: past the data, fully padded zero-weight batches."""
    n = data.num_examples
    flat = data.as_flat()
    total = num_batches if num_batches is not None else -(-n // batch_size)
    for b in range(total):
        start = b * batch_size
        valid = min(max(n - start, 0), batch_size)
        batch = {k: v[start: start + valid] for k, v in flat.items()}
        if valid < batch_size:
            batch = _pad_to(batch, batch_size)
        batch["_weights"] = _mask(valid, batch_size)
        batch["_index"] = np.concatenate(
            [index_offset + start + np.arange(valid, dtype=np.int32),
             np.full(batch_size - valid, -1, np.int32)])
        yield batch


def zero_batch(schema: Schema, batch_size: int) -> dict[str, np.ndarray]:
    """An all-padding batch (zero ``_weights``, ``_index`` = -1) with the
    schema's exact shapes and dtypes."""
    batch = {k: np.zeros(shape, dtype) for k, (shape, dtype) in schema.batch_spec(batch_size).items()}
    batch["_weights"] = np.zeros(batch_size, np.float32)
    batch["_index"] = np.full(batch_size, -1, np.int32)
    return batch


def _translated_chunk_stream(
    path: str,
    schema: Schema,
    vocabs: VocabularyStore,
    chunk_records: int,
    limit: int | None,
    host_index: int,
    host_count: int,
    cache: ChunkCache | None,
) -> Iterator[dict[str, np.ndarray]]:
    """One pass of this host's strided chunk set as translated flat arrays.

    Chunk ``c`` belongs to host ``c % host_count``; the native reader resumes
    from a carried byte offset so the framing walk is one pass per epoch.
    With a ``cache``, a complete prior pass is served from disk and a fresh
    pass spills each chunk as it goes, writing the manifest only at the end.
    """
    if cache is not None and cache.valid():
        yield from cache.serve()
        return
    offset = -1  # byte offset carried between native reads
    c = 0        # this host's chunk counter
    taken = 0
    while True:
        want = chunk_records
        if limit is not None:
            want = min(want, limit - taken)
            if want <= 0:
                break
        if offset > 0:
            skip = (host_count - 1) * chunk_records
        else:
            skip = (c * host_count + host_index) * chunk_records
        box: list = []
        data = load_dataset(path, schema, vocabs, limit=want, skip=skip,
                            start_offset=offset, end_offset_box=box)
        if data.num_examples == 0:
            break
        taken += data.num_examples
        flat = dict(data.as_flat())
        if cache is not None:
            cache.add(flat)
        yield flat
        if data.num_examples < want:
            break
        c += 1
        offset = box[0]
    if cache is not None:
        cache.finish()


def stream_eval_batches(
    path: str,
    schema: Schema,
    vocabs: VocabularyStore,
    batch_size: int,
    chunk_records: int = 65536,
    limit: int | None = None,
    host_index: int = 0,
    host_count: int = 1,
    cache_dir: str | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Bounded-RAM eval stream: chunked reads, no shuffle, global row ids.

    This host reads the strided chunk set ``c % host_count == host_index``
    and yields fixed-shape ``eval_batches``-style batches whose ``_index``
    carries the global record number.  Peak memory: one chunk.
    ``cache_dir`` spills translated chunks on the first pass so later passes
    serve from disk (see :class:`ChunkCache`)."""
    cache = None
    if cache_dir:
        cache = ChunkCache(cache_dir, _stream_identity(
            path, schema, vocabs, chunk_records=chunk_records, limit=limit,
            host_index=host_index, host_count=host_count))
    carry: dict[str, np.ndarray] | None = None  # partial batch across chunks

    def slices(flat: dict[str, np.ndarray]):
        """Cut a chunk (plus any carried partial rows) into full batches."""
        nonlocal carry
        if carry is not None:
            flat = {k: np.concatenate([carry[k], flat[k]]) for k in flat}
            carry = None
        n = len(flat["_index"])
        full = n // batch_size
        for b in range(full):
            yield {k: v[b * batch_size: (b + 1) * batch_size] for k, v in flat.items()}
        if n % batch_size:
            carry = {k: v[full * batch_size:] for k, v in flat.items()}

    for c, flat in enumerate(_translated_chunk_stream(
            path, schema, vocabs, chunk_records, limit, host_index, host_count, cache)):
        n_ex = len(flat["labels"])
        global_start = (c * host_count + host_index) * chunk_records
        flat["_weights"] = np.ones(n_ex, np.float32)
        flat["_index"] = global_start + np.arange(n_ex, dtype=np.int32)
        yield from slices(flat)
    if carry is not None:  # pad the tail to the fixed shape
        out = _pad_to(carry, batch_size)
        valid = len(carry["_index"])
        out["_weights"][valid:] = 0.0
        out["_index"][valid:] = -1
        yield out


def stream_batches(
    path: str,
    schema: Schema,
    vocabs: VocabularyStore,
    batch_size: int,
    num_epochs: int = 1,
    shuffle_buffer_size: int = 10000,
    seed: int = 0,
    chunk_records: int = 65536,
    max_steps: int | None = None,
    drop_remainder: bool = True,
    limit: int | None = None,
    host_index: int = 0,
    host_count: int = 1,
    cache_dir: str | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Bounded-memory streaming batch source for splits larger than RAM.

    Reads the TFRecord split in ``chunk_records`` chunks through the native
    reader's skip/limit range and shuffles through a row pool: the
    reference's ``TFRecordDataset -> shuffle(10000) -> repeat -> batch``
    semantics (algorithm/utils.py:18-26).  The pool holds
    ``max(shuffle_buffer_size, batch_size)`` rows, so a batch larger than
    the buffer still draws distinct rows.  Peak memory: one chunk + the
    pool.

    ``(host_index, host_count)`` make each host stream a disjoint strided
    set of chunks; ``limit`` caps records read per epoch (per host).
    ``cache_dir`` spills each chunk's translated arrays during epoch 1 so
    later epochs serve from disk; the pool still draws afresh each epoch.
    """
    rng = np.random.default_rng((seed, host_index))
    capacity = max(shuffle_buffer_size, batch_size)
    steps = 0
    identity = None
    if cache_dir:
        identity = _stream_identity(
            path, schema, vocabs, chunk_records=chunk_records, limit=limit,
            host_index=host_index, host_count=host_count)

    def rows():
        for _ in range(num_epochs):
            # a fresh ChunkCache per pass: its chunk counter restarts at 0, so
            # a pass abandoned mid-epoch (max_steps) leaves no manifest
            cache = ChunkCache(cache_dir, identity) if identity else None
            yield from _translated_chunk_stream(
                path, schema, vocabs, chunk_records, limit, host_index, host_count, cache)

    # tf.data-style shuffle buffer: a fixed-capacity row pool; each output
    # row is drawn from a uniformly random slot and the slot is refilled
    # with the next incoming row, vectorised per batch (draw batch_size
    # distinct slots, gather, scatter the next batch_size rows into them)
    buf: dict[str, np.ndarray] = {}
    buf_n = 0          # filled prefix of the buffer
    pending: list[dict[str, np.ndarray]] = []  # chunk slices not yet pooled
    queued = 0

    def pop_rows(n: int) -> dict[str, np.ndarray]:
        """Dequeue exactly n rows from the pending chunk views."""
        nonlocal queued
        parts, need = [], n
        while need:
            head = pending[0]
            hn = len(head["labels"])
            if hn <= need:
                parts.append(pending.pop(0))
                need -= hn
            else:
                parts.append({k: v[:need] for k, v in head.items()})
                pending[0] = {k: v[need:] for k, v in head.items()}
                need = 0
        queued -= n
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def fill_buffer() -> None:
        """Top the buffer up to capacity from the pending rows."""
        nonlocal buf_n
        if not buf:
            for k, v in pending[0].items():
                buf[k] = np.empty((capacity,) + v.shape[1:], v.dtype)
        while buf_n < capacity and queued:
            take = min(capacity - buf_n, queued)
            for k, v in pop_rows(take).items():
                buf[k][buf_n:buf_n + take] = v
            buf_n += take

    for flat in rows():
        pending.append(flat)
        queued += len(flat["labels"])
        fill_buffer()
        while buf_n == capacity and queued >= batch_size:
            idx = rng.choice(buf_n, size=batch_size, replace=False)
            batch = {k: v[idx] for k, v in buf.items()}
            for k, v in pop_rows(batch_size).items():
                buf[k][idx] = v
            yield batch
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return
    # drain: permute what is left (buffer prefix + pending remainder) once
    leftover = [{k: v[:buf_n] for k, v in buf.items()}] if buf_n else []
    leftover += pending
    if not leftover:
        return
    pool = (leftover[0] if len(leftover) == 1 else
            {k: np.concatenate([p[k] for p in leftover]) for k in leftover[0]})
    order = rng.permutation(len(pool["labels"]))
    pool = {k: v[order] for k, v in pool.items()}
    n_pool = len(order)
    for b in range(n_pool // batch_size):
        yield {k: v[b * batch_size:(b + 1) * batch_size] for k, v in pool.items()}
        steps += 1
        if max_steps is not None and steps >= max_steps:
            return
    tail = n_pool % batch_size
    if tail and not drop_remainder:
        out = _pad_to({k: v[n_pool - tail:] for k, v in pool.items()}, batch_size)
        out["_weights"] = _mask(tail, batch_size)
        yield out


def prefetch(it: Iterator, depth: int = 1) -> Iterator:
    """Background-thread prefetch (tf.data prefetch(1) parity).  The worker
    stops when the consumer closes or drops this generator."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            err.append(e)
        put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
