// Native TFRecord / tf.train.SequenceExample WRITER.
//
// The ETL's slowest stage is materialising the TFRecord splits: the
// reference writes 3.3M SequenceExamples row-by-row through Python protobuf
// (dataset/wechat_algo_data1/DataGenerator.py:390-447), and the pure-Python
// writer here (data/tfrecord.py encode_sequence_example) has the same
// shape.  This is its byte-identical native twin: the caller marshals the
// dataframe into columnar buffers once, rows are proto-encoded in parallel
// worker threads, and the framed records (length + masked crc32c + payload
// + payload crc) are written in order.
//
// Byte-identity with data/tfrecord.py is load-bearing (tested in
// tests/test_torch_data.py): context entries are emitted in the given
// field order (dense, categorical, labels — matching data/etl.py), each
// Feature uses the same submessage layout, and feature_lists hold one
// single-value bytes Feature per step.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (runtime/loader.py does
// this on first use, into build/ at the repository root).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// crc32c (software, slice-by-1)
// ---------------------------------------------------------------------------

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc_table[i] = crc;
  }
  crc_init_done = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// protobuf wire helpers (append-to-string encoders)
// ---------------------------------------------------------------------------

void put_varint(std::string& out, uint64_t x) {
  while (x >= 0x80) {
    out.push_back(static_cast<char>((x & 0x7F) | 0x80));
    x >>= 7;
  }
  out.push_back(static_cast<char>(x));
}

// field header for wire type 2 (length-delimited) + length
void put_ld_header(std::string& out, int field, size_t len) {
  put_varint(out, static_cast<uint64_t>(field) << 3 | 2);
  put_varint(out, len);
}

void put_ld(std::string& out, int field, const std::string& payload) {
  put_ld_header(out, field, payload.size());
  out.append(payload);
}

void put_ld(std::string& out, int field, const char* data, size_t len) {
  put_ld_header(out, field, len);
  out.append(data, len);
}

// Feature{ float_list = FloatList{ value: packed floats } }  (field 2)
void put_float_feature(std::string& out, const float* vals, int n) {
  std::string packed(reinterpret_cast<const char*>(vals),
                     sizeof(float) * static_cast<size_t>(n));
  std::string flist;
  put_ld(flist, 1, packed);
  put_ld(out, 2, flist);
}

// Feature{ bytes_list = BytesList{ value: repeated bytes } }  (field 1)
void put_bytes_feature(std::string& out, const char* const* toks,
                       const size_t* lens, int n) {
  std::string blist;
  for (int i = 0; i < n; ++i) put_ld(blist, 1, toks[i], lens[i]);
  put_ld(out, 1, blist);
}

// map entry: Entry{ key = 1, value = 2 } wrapped as `field` of the parent
void put_map_entry(std::string& out, int field, const std::string& key,
                   const std::string& value) {
  std::string entry;
  put_ld(entry, 1, key);
  put_ld(entry, 2, value);
  put_ld(out, field, entry);
}

std::vector<std::string> split_names(const char* joined) {
  std::vector<std::string> out;
  if (!joined || !*joined) return out;
  const char* p = joined;
  while (true) {
    const char* nl = strchr(p, '\n');
    if (!nl) {
      out.emplace_back(p);
      break;
    }
    out.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Writes n_rows SequenceExamples.  Layout contracts (all row-major):
//   dense:  (n_rows, n_dense) f32; one single-value float Feature per name.
//   cats:   token bytes for (row, field) at cat_blob[cat_offsets[row*n_cat+f]
//           .. cat_offsets[row*n_cat+f+1]]; one single-value bytes Feature.
//   labels: (n_rows, n_labels) f32, after the categorical entries.
//   seqs:   per (row, field) the token range is seq_row_offsets[row*n_seq+f]
//           .. [row*n_seq+f+1] indexing seq_tok_offsets, which bounds each
//           token's bytes in seq_blob; one FeatureList with a single-value
//           bytes Feature per step.
//   append: 0 truncates, 1 appends — the Python binding streams the file in
//           bounded row chunks so RAM stays O(chunk), not O(split).
// Returns rows written, or -1 on I/O failure.
int64_t write_sequence_examples(
    const char* path, int64_t n_rows,
    const char* dense_names_joined, int32_t n_dense, const float* dense,
    const char* cat_names_joined, int32_t n_cat, const char* cat_blob,
    const int64_t* cat_offsets,
    const char* label_names_joined, int32_t n_labels, const float* labels,
    const char* seq_names_joined, int32_t n_seq, const char* seq_blob,
    const int64_t* seq_tok_offsets, const int64_t* seq_row_offsets,
    int32_t append) {
  crc_init();
  const auto dense_names = split_names(dense_names_joined);
  const auto cat_names = split_names(cat_names_joined);
  const auto label_names = split_names(label_names_joined);
  const auto seq_names = split_names(seq_names_joined);
  if (static_cast<int32_t>(dense_names.size()) != n_dense ||
      static_cast<int32_t>(cat_names.size()) != n_cat ||
      static_cast<int32_t>(label_names.size()) != n_labels ||
      static_cast<int32_t>(seq_names.size()) != n_seq)
    return -1;

  // encoders: the host's hardware concurrency, capped at 16
  const unsigned hc = std::thread::hardware_concurrency();
  int32_t n_threads = static_cast<int32_t>(hc ? (hc > 16 ? 16 : hc) : 1);
  if (n_threads > n_rows && n_rows > 0)
    n_threads = static_cast<int32_t>(n_rows);

  // one framed record (12-byte header + payload + 4-byte crc) per row
  std::vector<std::string> framed(static_cast<size_t>(n_rows));

  auto encode_range = [&](int64_t lo, int64_t hi) {
    std::string payload, ctx, fls, feat, flist, step;
    for (int64_t r = lo; r < hi; ++r) {
      ctx.clear();
      for (int32_t f = 0; f < n_dense; ++f) {
        feat.clear();
        put_float_feature(feat, dense + r * n_dense + f, 1);
        put_map_entry(ctx, 1, dense_names[f], feat);
      }
      for (int32_t f = 0; f < n_cat; ++f) {
        const int64_t lo_b = cat_offsets[r * n_cat + f];
        const int64_t hi_b = cat_offsets[r * n_cat + f + 1];
        const char* tok = cat_blob + lo_b;
        const size_t len = static_cast<size_t>(hi_b - lo_b);
        feat.clear();
        put_bytes_feature(feat, &tok, &len, 1);
        put_map_entry(ctx, 1, cat_names[f], feat);
      }
      for (int32_t f = 0; f < n_labels; ++f) {
        feat.clear();
        put_float_feature(feat, labels + r * n_labels + f, 1);
        put_map_entry(ctx, 1, label_names[f], feat);
      }
      fls.clear();
      for (int32_t f = 0; f < n_seq; ++f) {
        flist.clear();
        const int64_t t0 = seq_row_offsets[r * n_seq + f];
        const int64_t t1 = seq_row_offsets[r * n_seq + f + 1];
        for (int64_t t = t0; t < t1; ++t) {
          const char* tok = seq_blob + seq_tok_offsets[t];
          const size_t len =
              static_cast<size_t>(seq_tok_offsets[t + 1] - seq_tok_offsets[t]);
          step.clear();
          put_bytes_feature(step, &tok, &len, 1);
          put_ld(flist, 1, step);
        }
        put_map_entry(fls, 1, seq_names[f], flist);
      }
      payload.clear();
      put_ld(payload, 1, ctx);
      put_ld(payload, 2, fls);

      // TFRecord framing: u64 length, masked crc(length), payload, crc(payload)
      std::string& rec = framed[static_cast<size_t>(r)];
      rec.clear();
      uint64_t len = payload.size();
      rec.append(reinterpret_cast<const char*>(&len), 8);
      uint32_t len_crc =
          masked_crc(reinterpret_cast<const uint8_t*>(rec.data()), 8);
      rec.append(reinterpret_cast<const char*>(&len_crc), 4);
      rec.append(payload);
      uint32_t data_crc = masked_crc(
          reinterpret_cast<const uint8_t*>(payload.data()), payload.size());
      rec.append(reinterpret_cast<const char*>(&data_crc), 4);
    }
  };

  if (n_threads <= 1 || n_rows == 0) {
    encode_range(0, n_rows);
  } else {
    std::vector<std::thread> pool;
    const int64_t per = (n_rows + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t lo = t * per;
      const int64_t hi = lo + per < n_rows ? lo + per : n_rows;
      if (lo >= hi) break;
      pool.emplace_back(encode_range, lo, hi);
    }
    for (auto& th : pool) th.join();
  }

  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  for (const auto& rec : framed) {
    if (fwrite(rec.data(), 1, rec.size(), f) != rec.size()) {
      fclose(f);
      return -1;
    }
  }
  if (fclose(f) != 0) return -1;
  return n_rows;
}

}  // extern "C"
