// Native TFRecord + SequenceExample batch reader.
//
// The reference relies on TF's C++ tf.data runtime for input
// (algorithm/utils.py:18-26); this framework's native equivalent parses the
// identical on-disk format (TFRecord framing + protobuf wire format for
// tf.train.SequenceExample) and emits fixed-shape, vocabulary-translated
// arrays directly into caller-provided buffers — one pass, no Python object
// churn, no TensorFlow dependency.  Exposed to Python via ctypes
// (runtime/loader.py); the pure-Python parser in data/tfrecord.py is the
// behavioural oracle (tests/test_torch_data.py asserts equivalence).  The
// records' CRCs are not checked.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (runtime/loader.py does
// this on first use, into build/ at the repository root).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <thread>
#include <algorithm>

namespace {

// Worker threads for the parse and the row gather: the host's hardware
// concurrency, capped at 16.
int64_t worker_threads() {
  const unsigned hc = std::thread::hardware_concurrency();
  return hc ? std::min<int64_t>(hc, 16) : 1;
}

// ---------------------------------------------------------------------------
// protobuf wire-format primitives
// ---------------------------------------------------------------------------

struct Slice {
  const uint8_t* p;
  size_t n;
};

bool read_varint(Slice& s, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (s.n > 0) {
    uint8_t b = *s.p;
    s.p++;
    s.n--;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Iterates fields of one message; calls visit(field, wire, payload).
template <typename F>
bool iter_fields(Slice msg, F&& visit) {
  while (msg.n > 0) {
    uint64_t tag;
    if (!read_varint(msg, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    Slice payload{nullptr, 0};
    uint64_t varint_val = 0;
    switch (wire) {
      case 0:
        if (!read_varint(msg, &varint_val)) return false;
        payload.p = reinterpret_cast<const uint8_t*>(&varint_val);
        payload.n = 8;
        visit(field, wire, payload, varint_val);
        continue;
      case 2: {
        uint64_t len;
        if (!read_varint(msg, &len) || len > msg.n) return false;
        payload = {msg.p, static_cast<size_t>(len)};
        msg.p += len;
        msg.n -= len;
        break;
      }
      case 5:
        if (msg.n < 4) return false;
        payload = {msg.p, 4};
        msg.p += 4;
        msg.n -= 4;
        break;
      case 1:
        if (msg.n < 8) return false;
        payload = {msg.p, 8};
        msg.p += 8;
        msg.n -= 8;
        break;
      default:
        return false;
    }
    visit(field, wire, payload, varint_val);
  }
  return true;
}

// Feature message: kind 1 bytes_list / 2 float_list / 3 int64_list.
struct FeatureView {
  int kind = 0;                       // 0 = absent
  std::vector<Slice> bytes_values;    // kind 1
  std::vector<float> float_values;    // kind 2
  std::vector<int64_t> int_values;    // kind 3
};

void parse_feature(Slice buf, FeatureView* out) {
  iter_fields(buf, [&](uint32_t field, uint32_t wire, Slice val, uint64_t) {
    if (field == 1) {  // BytesList
      out->kind = 1;
      iter_fields(val, [&](uint32_t f2, uint32_t, Slice v, uint64_t) {
        if (f2 == 1) out->bytes_values.push_back(v);
      });
    } else if (field == 2) {  // FloatList
      out->kind = 2;
      iter_fields(val, [&](uint32_t f2, uint32_t w2, Slice v, uint64_t) {
        if (f2 != 1) return;
        if (w2 == 2) {  // packed
          size_t cnt = v.n / 4;
          for (size_t i = 0; i < cnt; ++i) {
            float f;
            std::memcpy(&f, v.p + 4 * i, 4);
            out->float_values.push_back(f);
          }
        } else if (w2 == 5) {
          float f;
          std::memcpy(&f, v.p, 4);
          out->float_values.push_back(f);
        }
      });
    } else if (field == 3) {  // Int64List
      out->kind = 3;
      iter_fields(val, [&](uint32_t f2, uint32_t w2, Slice v, uint64_t x) {
        if (f2 != 1) return;
        if (w2 == 2) {  // packed varints
          Slice s = v;
          uint64_t y;
          while (s.n > 0 && read_varint(s, &y))
            out->int_values.push_back(static_cast<int64_t>(y));
        } else if (w2 == 0) {
          out->int_values.push_back(static_cast<int64_t>(x));
        }
      });
    }
  });
}

struct MapEntry {
  Slice key{nullptr, 0};
  Slice value{nullptr, 0};
};

MapEntry parse_map_entry(Slice buf) {
  MapEntry e;
  iter_fields(buf, [&](uint32_t field, uint32_t, Slice val, uint64_t) {
    if (field == 1) e.key = val;
    else if (field == 2) e.value = val;
  });
  return e;
}

// ---------------------------------------------------------------------------
// Vocabulary: token -> 1-based id (0 = PAD/OOV), loaded from the ETL's txts.
// ---------------------------------------------------------------------------

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t lookup(Slice tok) const {
    auto it = map.find(std::string(reinterpret_cast<const char*>(tok.p), tok.n));
    return it == map.end() ? 0 : it->second;
  }
};

}  // namespace

extern "C" {

// Opaque reader handle holding the schema layout + vocabularies.
struct Reader {
  // feature name tables (flat, index-addressed from Python)
  std::vector<std::string> dense_names;
  std::vector<std::string> label_names;
  std::vector<std::string> cat_names;
  std::vector<std::string> seq_names;
  std::vector<int32_t> seq_max_len;
  std::vector<Vocab> cat_vocabs;  // aligned with cat_names
  std::vector<Vocab> seq_vocabs;  // aligned with seq_names
};

Reader* reader_create() { return new Reader(); }
void reader_destroy(Reader* r) { delete r; }

void reader_add_dense(Reader* r, const char* name) {
  r->dense_names.emplace_back(name);
}
void reader_add_label(Reader* r, const char* name) {
  r->label_names.emplace_back(name);
}

// vocab_blob: '\n'-separated tokens in file order (line i -> id i+1).
static Vocab make_vocab(const char* blob, int64_t blob_len) {
  Vocab v;
  int32_t id = 1;
  const char* p = blob;
  const char* end = blob + blob_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    if (len > 0) v.map.emplace(std::string(p, len), id++);
    p += len + 1;
  }
  return v;
}

void reader_add_categorical(Reader* r, const char* name, const char* vocab_blob,
                            int64_t blob_len) {
  r->cat_names.emplace_back(name);
  r->cat_vocabs.push_back(make_vocab(vocab_blob, blob_len));
}

void reader_add_sequence(Reader* r, const char* name, int32_t max_len,
                         const char* vocab_blob, int64_t blob_len) {
  r->seq_names.emplace_back(name);
  r->seq_max_len.push_back(max_len);
  r->seq_vocabs.push_back(make_vocab(vocab_blob, blob_len));
}

// Parses up to `capacity` SequenceExamples from a TFRecord file into
// caller-provided row-major buffers.  Returns rows read, or -1 on error.
//   dense_out  : (capacity, n_dense) f32
//   labels_out : (capacity, n_labels) f32
//   cat_out    : (capacity, n_cat) i32  (column-per-categorical)
//   seq_out    : concatenated per-seq blocks: for seq s with max_len T_s,
//                block of (capacity, T_s) i32 at offset seq_offsets[s]
//   seq_len_out: (capacity, n_seq) i32
int64_t reader_read_file(Reader* r, const char* path, int64_t capacity,
                         float* dense_out, float* labels_out, int32_t* cat_out,
                         int32_t* seq_out, const int64_t* seq_offsets,
                         int32_t* seq_len_out, int64_t skip,
                         int64_t start_offset, int64_t* end_offset_out) {
  if (end_offset_out) *end_offset_out = -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // chunked/streaming reads: seek to a byte offset carried from the
  // previous chunk (O(1)), then optionally skip `skip` further records by
  // walking the framing (no parsing) — callers load a split in
  // bounded-memory chunks without quadratic re-walks, and strided
  // multi-host readers compose offset + skip for their inter-chunk gaps
  if (start_offset > 0) {
    if (fseek(f, static_cast<long>(start_offset), SEEK_SET) != 0) {
      fclose(f);
      return 0;
    }
  }
  for (int64_t s = 0; s < skip; ++s) {
    uint8_t h[12];
    if (fread(h, 1, 12, f) != 12) { fclose(f); return 0; }
    uint64_t len;
    std::memcpy(&len, h, 8);
    if (fseek(f, static_cast<long>(len + 4), SEEK_CUR) != 0) {
      fclose(f);
      return 0;
    }
  }
  const size_t n_dense = r->dense_names.size();
  const size_t n_labels = r->label_names.size();
  const size_t n_cat = r->cat_names.size();
  const size_t n_seq = r->seq_names.size();

  // Two-phase, wave-buffered: the serial I/O phase reads up to WAVE record
  // payloads into one buffer (bounding memory for whole-file loads), then
  // the parse/translate phase fans the independent records across threads —
  // vocab maps are read-only and every record writes disjoint row slots.
  auto parse_record = [&](const uint8_t* data, size_t len, int64_t row) {
    std::memset(dense_out + row * n_dense, 0, n_dense * 4);
    std::memset(labels_out + row * n_labels, 0, n_labels * 4);
    for (size_t c = 0; c < n_cat; ++c) cat_out[row * n_cat + c] = 0;
    for (size_t s = 0; s < n_seq; ++s) {
      int32_t t = r->seq_max_len[s];
      std::memset(seq_out + seq_offsets[s] + row * t, 0, t * 4);
      seq_len_out[row * n_seq + s] = 0;
    }
    Slice msg{data, len};
    iter_fields(msg, [&](uint32_t field, uint32_t, Slice val, uint64_t) {
      if (field == 1) {  // context Features
        iter_fields(val, [&](uint32_t f2, uint32_t, Slice entry, uint64_t) {
          if (f2 != 1) return;
          MapEntry e = parse_map_entry(entry);
          std::string key(reinterpret_cast<const char*>(e.key.p), e.key.n);
          FeatureView fv;
          // dense / labels (float)
          for (size_t d = 0; d < n_dense; ++d) {
            if (key == r->dense_names[d]) {
              parse_feature(e.value, &fv);
              if (!fv.float_values.empty())
                dense_out[row * n_dense + d] = fv.float_values[0];
              return;
            }
          }
          for (size_t l = 0; l < n_labels; ++l) {
            if (key == r->label_names[l]) {
              parse_feature(e.value, &fv);
              if (!fv.float_values.empty())
                labels_out[row * n_labels + l] = fv.float_values[0];
              return;
            }
          }
          for (size_t c = 0; c < n_cat; ++c) {
            if (key == r->cat_names[c]) {
              parse_feature(e.value, &fv);
              if (!fv.bytes_values.empty())
                cat_out[row * n_cat + c] =
                    r->cat_vocabs[c].lookup(fv.bytes_values[0]);
              return;
            }
          }
        });
      } else if (field == 2) {  // feature_lists
        iter_fields(val, [&](uint32_t f2, uint32_t, Slice entry, uint64_t) {
          if (f2 != 1) return;
          MapEntry e = parse_map_entry(entry);
          std::string key(reinterpret_cast<const char*>(e.key.p), e.key.n);
          for (size_t s = 0; s < n_seq; ++s) {
            if (key != r->seq_names[s]) continue;
            const int32_t t_max = r->seq_max_len[s];
            // collect tokens, keep the LAST t_max (ETL truncation parity,
            // DataGenerator.py:273-276 truncates at write time; re-applied
            // defensively here)
            std::vector<Slice> toks;
            iter_fields(e.value, [&](uint32_t f3, uint32_t, Slice fbuf,
                                     uint64_t) {
              if (f3 != 1) return;
              FeatureView fv;
              parse_feature(fbuf, &fv);
              if (!fv.bytes_values.empty()) toks.push_back(fv.bytes_values[0]);
            });
            size_t start = toks.size() > static_cast<size_t>(t_max)
                               ? toks.size() - t_max
                               : 0;
            int32_t* dst = seq_out + seq_offsets[s] + row * t_max;
            int32_t cnt = 0;
            for (size_t i = start; i < toks.size(); ++i)
              dst[cnt++] = r->seq_vocabs[s].lookup(toks[i]);
            seq_len_out[row * n_seq + s] = cnt;
            return;
          }
        });
      }
    });
  };

  const int64_t WAVE = 65536;
  std::vector<uint8_t> payload;
  std::vector<size_t> offs;
  std::vector<size_t> lens;
  int64_t row = 0;
  bool eof = false;
  uint8_t header[12];
  while (!eof && row < capacity) {
    payload.clear();
    offs.clear();
    lens.clear();
    while (static_cast<int64_t>(offs.size()) < WAVE &&
           row + static_cast<int64_t>(offs.size()) < capacity) {
      if (fread(header, 1, 12, f) != 12) { eof = true; break; }
      uint64_t len;
      std::memcpy(&len, header, 8);
      size_t off = payload.size();
      payload.resize(off + len + 4);
      if (fread(payload.data() + off, 1, len + 4, f) != len + 4) {
        eof = true;
        break;
      }
      offs.push_back(off);
      lens.push_back(len);
    }
    const int64_t wave_rows = static_cast<int64_t>(offs.size());
    if (wave_rows == 0) break;
    auto work = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i)
        parse_record(payload.data() + offs[i], lens[i], row + i);
    };
    const int64_t nt = std::min(worker_threads(), wave_rows);
    if (nt == 1) {
      work(0, wave_rows);
    } else {
      std::vector<std::thread> threads;
      int64_t chunk = (wave_rows + nt - 1) / nt;
      for (int64_t t = 0; t < nt; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(wave_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
      }
      for (auto& th : threads) th.join();
    }
    row += wave_rows;
  }
  if (end_offset_out) *end_offset_out = ftell(f);
  fclose(f);
  return row;
}

// ---------------------------------------------------------------------------
// permute_rows: parallel random-row gather dst[i] = src[order[i]].
//
// The input pipeline shuffles by permuting the whole epoch once and then
// serving contiguous views (data/pipeline.py).  numpy's fancy indexing does
// this gather single-threaded through generic strided machinery; a straight
// per-row memcpy fanned over threads is ~the memory bandwidth limit and
// scales with host cores.
// ---------------------------------------------------------------------------
void permute_rows(const char* src, char* dst, const int64_t* order,
                  int64_t n_rows, int64_t row_bytes) {
  const int64_t n_threads = worker_threads();
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      memcpy(dst + i * row_bytes, src + order[i] * row_bytes, row_bytes);
  };
  if (n_threads == 1) {
    work(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
