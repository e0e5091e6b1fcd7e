"""ctypes bindings for the native TFRecord/SequenceExample reader and writer.

Counterpart of ``recalgorithm_tpu/runtime/loader.py``.  ``runtime/cc/<name>.cc``
is built on first use with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into
``build/<name>-<hash>.so`` at the repository root (the directory the CUDA
kernels of ``ops/cuda/_build.py`` are built into); the hash covers the source
and the flags, so a library is rebuilt only when its source changes.  Each
build writes a name of its own and renames it into place, so processes that
build at once (test workers) never load half a file.

Nothing falls back: a missing compiler, a failed build or a failed read
raises.  The pure-Python parser of ``data/pipeline.py`` runs only when its
caller asks for it (``prefer_native=False``).

  * ``read_dataset`` — threaded parse + vocabulary translation into the same
    ``DatasetArrays`` as the Python parser, with ``skip``/``limit`` and a
    byte offset carried between chunked reads (record CRCs are not checked);
  * ``write_sequence_examples`` — parallel encode, byte-identical to
    ``data/tfrecord.py``'s encoder in the ETL's field order;
  * ``permute_rows`` — the threaded row gather of the epoch shuffle.

The native code runs one worker thread a core, up to 16.  ``DatasetArrays``
lives here, the lower layer, and ``data/pipeline.py`` imports it from here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import struct
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np

from recalgorithm_tpu_torch.features.schema import Schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore

CC = Path(__file__).resolve().parent / "cc"
BUILD = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# rows marshalled and encoded a native write: bounds the writer's RAM to one
# chunk's token encodings, and the ETLs cut their dataframes to it
CHUNK_ROWS = 200_000

_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "tfrecord_reader": {
        "reader_create": (ctypes.c_void_p, []),
        "reader_destroy": (None, [ctypes.c_void_p]),
        "reader_add_dense": (None, [ctypes.c_void_p, ctypes.c_char_p]),
        "reader_add_label": (None, [ctypes.c_void_p, ctypes.c_char_p]),
        "reader_add_categorical": (None, [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_char_p, ctypes.c_int64]),
        "reader_add_sequence": (None, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                       ctypes.c_char_p, ctypes.c_int64]),
        "reader_read_file": (ctypes.c_int64, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _f32p, _f32p, _i32p, _i32p,
            _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, _i64p]),
        "permute_rows": (None, [ctypes.c_char_p, ctypes.c_char_p, _i64p, ctypes.c_int64,
                                ctypes.c_int64]),
    },
    "tfrecord_writer": {
        "write_sequence_examples": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int32, _f32p,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, _i64p,
            ctypes.c_char_p, ctypes.c_int32, _f32p,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, _i64p, _i64p,
            ctypes.c_int32]),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class DatasetArrays:
    """The fully-translated dataset as flat arrays (row-major over examples)."""

    dense: np.ndarray          # (N, n_dense) f32
    categorical: dict          # name -> (N,) i32
    sequences: dict            # name -> ((N, T) i32, (N,) i32 lengths)
    labels: np.ndarray         # (N, n_labels) f32

    @property
    def num_examples(self) -> int:
        return self.labels.shape[0]

    def row_batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.as_flat().items()}

    def as_flat(self) -> dict[str, np.ndarray]:
        """All columns as views (no copy), keyed like a batch."""
        out = {"dense": self.dense, "labels": self.labels}
        for name, arr in self.categorical.items():
            out[name] = arr
        for name, (ids, lens) in self.sequences.items():
            out[name] = ids
            out[name + "_len"] = lens
        return out


def build(name: str) -> Path:
    """Build ``cc/<name>.cc`` into ``build/`` unless it is built; returns the
    library's path.  Raises ``RuntimeError`` when ``g++`` fails."""
    src = CC / f"{name}.cc"
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    target = BUILD / f"{name}-{digest[:16]}.so"
    if target.exists():
        return target
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{uuid.uuid4().hex}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return target


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return _loaded[name]


def write_sequence_examples(
    path: str,
    dense_names: list[str],
    dense: np.ndarray,              # (N, n_dense) f32
    cat_names: list[str],
    cat_cols: list[list[bytes]],    # per field, N token-bytes (b'' for missing)
    label_names: list[str],
    labels: np.ndarray,             # (N, n_labels) f32
    seq_names: list[str],
    seq_cols: list[list[list[bytes]]],  # per field, N lists of token-bytes
    append: bool = False,
) -> int:
    """Native SequenceExample TFRecord writer (runtime/cc/tfrecord_writer.cc).

    Byte-identical to data/tfrecord.encode_sequence_example + write_records
    with context entries ordered (dense, categorical, labels) — the
    data/etl.py layout.  The file is streamed in ``CHUNK_ROWS`` chunks
    (marshal + parallel proto-encode + append per chunk) so peak RAM is
    O(chunk), not O(split).  Returns rows written; raises on failure.
    """
    lib = _library("tfrecord_writer")
    n_rows = int(dense.shape[0]) if len(dense_names) else len(labels)
    dense = np.ascontiguousarray(dense, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    # a short column would truncate through zip and hand the native encoder
    # offsets past the end of its buffers
    for kind, names, cols in (("cat", cat_names, cat_cols), ("seq", seq_names, seq_cols)):
        if len(names) != len(cols):
            raise ValueError(f"{kind}: {len(names)} names vs {len(cols)} columns")
        for name, col in zip(names, cols):
            if len(col) != n_rows:
                raise ValueError(f"{kind} column {name!r} has {len(col)} rows, "
                                 f"expected {n_rows}")
    if len(label_names) and labels.shape[0] != n_rows:
        raise ValueError(f"labels have {labels.shape[0]} rows, expected {n_rows}")
    as_i64 = lambda a: a.ctypes.data_as(_i64p)
    as_f32 = lambda a: a.ctypes.data_as(_f32p)

    done = 0
    while True:
        lo, hi = done, min(done + CHUNK_ROWS, n_rows)
        n_chunk = hi - lo
        # categorical tokens, row-major by (row, field)
        flat_cats = [tok for row in zip(*(c[lo:hi] for c in cat_cols)) for tok in row]
        cat_offsets = np.zeros(len(flat_cats) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, flat_cats), np.int64, len(flat_cats)),
                  out=cat_offsets[1:])
        # sequence tokens, row-major by (row, field, step)
        row_lists = [toks for row in zip(*(c[lo:hi] for c in seq_cols)) for toks in row]
        row_offsets = np.zeros(len(row_lists) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, row_lists), np.int64, len(row_lists)),
                  out=row_offsets[1:])
        flat_seq = [tok for toks in row_lists for tok in toks]
        tok_offsets = np.zeros(len(flat_seq) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, flat_seq), np.int64, len(flat_seq)),
                  out=tok_offsets[1:])
        dense_part = np.ascontiguousarray(dense[lo:hi] if len(dense_names) else dense)
        label_part = np.ascontiguousarray(labels[lo:hi] if len(label_names) else labels)
        rows = lib.write_sequence_examples(
            path.encode(), n_chunk,
            "\n".join(dense_names).encode(), len(dense_names), as_f32(dense_part),
            "\n".join(cat_names).encode(), len(cat_names), b"".join(flat_cats),
            as_i64(cat_offsets),
            "\n".join(label_names).encode(), len(label_names), as_f32(label_part),
            "\n".join(seq_names).encode(), len(seq_names), b"".join(flat_seq),
            as_i64(tok_offsets), as_i64(row_offsets),
            1 if (done or append) else 0,
        )
        if rows != n_chunk:
            raise IOError(f"native writer failed on {path} ({rows}/{n_chunk} at row {lo})")
        done = hi
        if done >= n_rows:
            return n_rows


def _count_records(path: str) -> int:
    """Record count by walking the TFRecord framing."""
    n = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return n
            (length,) = struct.unpack("<Q", header[:8])
            f.seek(length + 4, 1)
            n += 1


def read_dataset(
    path: str,
    schema: Schema,
    vocabs: VocabularyStore,
    limit: int | None = None,
    skip: int = 0,
    start_offset: int = -1,
    end_offset_box: list | None = None,
) -> DatasetArrays:
    """Native parse + translate of a SequenceExample TFRecord file.

    ``skip``/``limit`` select a record range, enabling bounded-memory
    chunked loading (data/pipeline.stream_batches).  ``start_offset`` (a
    byte position carried from a previous read's ``end_offset_box``)
    replaces the record-skip walk with one seek, keeping chunked streaming
    O(records) overall; when ``limit`` is given the whole-file record count
    is skipped too.  Raises ``IOError`` when the reader fails.
    """
    lib = _library("tfrecord_reader")
    if limit is not None and start_offset > 0:
        # mid-stream chunk: allocate the (bounded) chunk size without a
        # full-file framing walk; rows are sliced to the actual count
        capacity = limit
    else:
        capacity = max(_count_records(path) - skip, 0)
        if limit is not None:
            capacity = min(capacity, limit)
    reader = lib.reader_create()
    try:
        for name in schema.dense_names:
            lib.reader_add_dense(reader, name.encode())
        for name in schema.labels:
            lib.reader_add_label(reader, name.encode())
        for f in schema.categorical:
            blob = "\n".join(vocabs[f.vocab].tokens()).encode()
            lib.reader_add_categorical(reader, f.name.encode(), blob, len(blob))
        seq_offsets = []
        offset = 0
        for f in schema.sequence:
            blob = "\n".join(vocabs[f.vocab].tokens()).encode()
            lib.reader_add_sequence(reader, f.name.encode(), f.max_length, blob, len(blob))
            seq_offsets.append(offset)
            offset += capacity * f.max_length

        dense = np.zeros((capacity, len(schema.dense)), np.float32)
        labels = np.zeros((capacity, len(schema.labels)), np.float32)
        cats = np.zeros((capacity, len(schema.categorical)), np.int32)
        seqs = np.zeros((offset,), np.int32)
        seq_lens = np.zeros((capacity, len(schema.sequence)), np.int32)
        offsets_arr = np.asarray(seq_offsets, np.int64)
        end_off = ctypes.c_int64(-1)
        rows = lib.reader_read_file(
            reader, path.encode(), capacity,
            dense.ctypes.data_as(_f32p), labels.ctypes.data_as(_f32p),
            cats.ctypes.data_as(_i32p), seqs.ctypes.data_as(_i32p),
            offsets_arr.ctypes.data_as(_i64p), seq_lens.ctypes.data_as(_i32p),
            skip, start_offset, ctypes.byref(end_off),
        )
    finally:
        lib.reader_destroy(reader)
    if rows < 0:
        raise IOError(f"native reader failed on {path}")
    rows = int(rows)
    if end_offset_box is not None:
        end_offset_box.append(int(end_off.value))
    sequences = {}
    for i, f in enumerate(schema.sequence):
        block = seqs[seq_offsets[i]: seq_offsets[i] + capacity * f.max_length]
        sequences[f.name] = (block.reshape(capacity, f.max_length)[:rows],
                             seq_lens[:rows, i].copy())
    return DatasetArrays(
        dense=dense[:rows],
        categorical={f.name: cats[:rows, i].copy() for i, f in enumerate(schema.categorical)},
        sequences=sequences,
        labels=labels[:rows],
    )


def permute_rows(arr: np.ndarray, order: np.ndarray) -> np.ndarray:
    """dst[i] = arr[order[i]] along axis 0: a threaded C row gather."""
    if len(order) != arr.shape[0]:
        raise ValueError(
            f"permute_rows needs a full permutation: len(order)={len(order)} "
            f"!= rows={arr.shape[0]} (the C gather loops over rows and would "
            "read past the end of a shorter order)")
    order = np.ascontiguousarray(order, dtype=np.int64)
    if order.size and (order.min() < 0 or order.max() >= arr.shape[0]):
        raise ValueError("permute_rows: order holds a row index out of range")
    lib = _library("tfrecord_reader")
    arr = np.ascontiguousarray(arr)
    out = np.empty_like(arr)
    row_bytes = arr.dtype.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64))
    lib.permute_rows(
        arr.ctypes.data_as(ctypes.c_char_p), out.ctypes.data_as(ctypes.c_char_p),
        order.ctypes.data_as(_i64p), arr.shape[0], row_bytes,
    )
    return out
