// Native append-log KV store — the Kesque storage-engine role in C++.
//
// Role parity: khipu-kesque's KesqueNodeDataSource.scala:18-230 (append
// log + 8-byte short-key index, KesqueIndex.scala:7-26, with the
// content-address verify at :61-63: node keys are NOT stored — they are
// recomputed as keccak256(value) on read, so the log stores pure value
// bytes and short-key collisions are disambiguated by hashing). The
// reference embeds a Kafka broker for its log and LMDB/RocksDB for the
// index; here the log is a flat append-only file and the index is an
// in-memory short-key -> offsets multimap checkpointed to a sidecar
// file (crash recovery rebuilds the uncovered tail by scanning the
// log, mirroring Kafka's log-recovery behavior).
//
// Two record modes per store:
//   content-addressed (nodes):  [u32 vlen][value]            key = kec256(value)
//   explicit-key (blocks/kv):   [u16 klen][key][u32 vlen][value]
// get() for explicit keys returns the LATEST record (offsets iterated
// newest-first), so re-puts behave as updates on an immutable log.
//
// C ABI (ctypes, khipu_tpu_torch/native/store.py). Not thread-safe: the
// Python wrapper holds one lock per store.

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

// Must match keccak.cc:95 exactly — a conflicting declaration of a
// C-linkage symbol across translation units is UB.
extern "C" void khipu_keccak(int rate, const uint8_t* in, uint64_t in_len,
                             uint8_t* out, int out_len);

namespace {

constexpr uint64_t kIdxMagic = 0x4b48495055494458ULL;  // "KHIPUIDX"

struct IdxHeader {
  uint64_t magic;
  uint64_t npairs;
  uint64_t covered_log_len;
};

struct Store {
  FILE* log = nullptr;
  FILE* idx = nullptr;
  bool content_addressed = true;
  uint64_t log_len = 0;
  uint64_t indexed_len = 0;  // log bytes covered by the in-memory index
  uint64_t count = 0;        // records indexed (re-puts count again)
  int64_t max_key8 = -1;     // max value among 8-byte keys (blocknum)
  std::unordered_map<uint64_t, std::vector<uint64_t>> index;
  std::string log_path, idx_path;
};

uint64_t short_key(const uint8_t* key, uint32_t klen) {
  // Last 8 bytes of the key (KesqueIndex.toShortKey keeps the tail).
  uint64_t out = 0;
  uint32_t start = klen > 8 ? klen - 8 : 0;
  for (uint32_t i = start; i < klen; ++i) out = (out << 8) | key[i];
  return out;
}

bool read_exact(FILE* f, uint64_t off, void* buf, size_t n) {
  if (fseeko(f, (off_t)off, SEEK_SET) != 0) return false;
  return fread(buf, 1, n, f) == n;
}

// Parse one record at `off`; fills lengths and returns total size, or 0
// when the record is torn/out of bounds.
uint64_t record_size(Store* s, uint64_t off, uint32_t* klen_out,
                     uint32_t* vlen_out) {
  if (s->content_addressed) {
    uint32_t vlen;
    if (off + 4 > s->log_len || !read_exact(s->log, off, &vlen, 4)) return 0;
    if (off + 4 + vlen > s->log_len) return 0;
    *klen_out = 0;
    *vlen_out = vlen;
    return 4 + (uint64_t)vlen;
  }
  uint16_t klen;
  if (off + 2 > s->log_len || !read_exact(s->log, off, &klen, 2)) return 0;
  uint32_t vlen;
  if (off + 2 + klen + 4 > s->log_len ||
      !read_exact(s->log, off + 2 + klen, &vlen, 4))
    return 0;
  if (off + 2 + klen + 4 + vlen > s->log_len) return 0;
  *klen_out = klen;
  *vlen_out = vlen;
  return 2 + (uint64_t)klen + 4 + (uint64_t)vlen;
}

bool record_key(Store* s, uint64_t off, std::vector<uint8_t>* key) {
  uint32_t klen, vlen;
  uint64_t sz = record_size(s, off, &klen, &vlen);
  if (!sz) return false;
  if (s->content_addressed) {
    std::vector<uint8_t> val(vlen);
    if (!read_exact(s->log, off + 4, val.data(), vlen)) return false;
    key->resize(32);
    khipu_keccak(136, val.data(), vlen, key->data(), 32);
  } else {
    key->resize(klen);
    if (!read_exact(s->log, off + 2, key->data(), klen)) return false;
  }
  return true;
}

void index_record(Store* s, uint64_t off, const uint8_t* key, uint32_t klen) {
  s->index[short_key(key, klen)].push_back(off);
  s->count++;
  if (klen == 8) {
    uint64_t n = short_key(key, 8);
    if ((int64_t)n > s->max_key8 && n <= (uint64_t)INT64_MAX)
      s->max_key8 = (int64_t)n;
  }
}

// Scan log records in [from, log_len) into the index; truncates a torn
// tail (crash mid-append). Appends the new pairs to the idx file.
void recover_tail(Store* s, uint64_t from) {
  uint64_t off = from;
  while (off < s->log_len) {
    uint32_t klen, vlen;
    uint64_t sz = record_size(s, off, &klen, &vlen);
    if (!sz) {  // torn record: drop it
      fflush(s->log);
      (void)!ftruncate(fileno(s->log), (off_t)off);
      s->log_len = off;
      break;
    }
    std::vector<uint8_t> key;
    if (!record_key(s, off, &key)) break;
    index_record(s, off, key.data(), (uint32_t)key.size());
    uint64_t pair[2] = {short_key(key.data(), (uint32_t)key.size()), off};
    fseeko(s->idx, 0, SEEK_END);
    fwrite(pair, 8, 2, s->idx);
    off += sz;
  }
  s->indexed_len = s->log_len;
}

void write_idx_header(Store* s) {
  IdxHeader h{kIdxMagic, s->count, s->indexed_len};
  fseeko(s->idx, 0, SEEK_SET);
  fwrite(&h, sizeof(h), 1, s->idx);
  fflush(s->idx);
}

}  // namespace

extern "C" {

void* kstore_open(const char* path_prefix, int content_addressed) {
  Store* s = new Store();
  s->content_addressed = content_addressed != 0;
  s->log_path = std::string(path_prefix) + ".log";
  s->idx_path = std::string(path_prefix) + ".idx";

  s->log = fopen(s->log_path.c_str(), "a+b");
  if (!s->log) {
    delete s;
    return nullptr;
  }
  fseeko(s->log, 0, SEEK_END);
  s->log_len = (uint64_t)ftello(s->log);

  s->idx = fopen(s->idx_path.c_str(), "r+b");
  if (!s->idx) s->idx = fopen(s->idx_path.c_str(), "w+b");
  if (!s->idx) {
    fclose(s->log);
    delete s;
    return nullptr;
  }

  IdxHeader h{};
  uint64_t covered = 0, npairs = 0;
  if (read_exact(s->idx, 0, &h, sizeof(h)) && h.magic == kIdxMagic) {
    npairs = h.npairs;
    covered = h.covered_log_len <= s->log_len ? h.covered_log_len : 0;
  } else {
    write_idx_header(s);
  }
  // Load checkpointed pairs, then re-scan anything the header does not
  // cover (including pairs written after the last header update — the
  // tail scan re-derives them from the log itself).
  fseeko(s->idx, sizeof(IdxHeader), SEEK_SET);
  for (uint64_t i = 0; i < npairs; ++i) {
    uint64_t pair[2];
    if (fread(pair, 8, 2, s->idx) != 2) break;
    if (pair[1] >= covered) continue;  // tail scan will re-add it
    s->index[pair[0]].push_back(pair[1]);
    s->count++;
  }
  if (!s->content_addressed) {
    // rebuild max_key8 from indexed records
    for (auto& kv : s->index)
      for (uint64_t off : kv.second) {
        std::vector<uint8_t> key;
        if (record_key(s, off, &key) && key.size() == 8) {
          uint64_t n = short_key(key.data(), 8);
          if ((int64_t)n > s->max_key8) s->max_key8 = (int64_t)n;
        }
      }
  }
  // Trim idx to exactly the checkpointed pairs, then index the tail.
  fflush(s->idx);
  (void)!ftruncate(fileno(s->idx),
                   (off_t)(sizeof(IdxHeader) + 16 * s->count));
  s->indexed_len = covered;
  recover_tail(s, covered);
  write_idx_header(s);
  return s;
}

int64_t kstore_get(void* handle, const uint8_t* key, uint32_t klen,
                   uint8_t* out, uint32_t cap) {
  Store* s = (Store*)handle;
  auto it = s->index.find(short_key(key, klen));
  if (it == s->index.end()) return -1;
  const std::vector<uint64_t>& offs = it->second;
  for (size_t i = offs.size(); i-- > 0;) {  // newest record wins
    uint64_t off = offs[i];
    uint32_t rklen, vlen;
    uint64_t sz = record_size(s, off, &rklen, &vlen);
    if (!sz) continue;
    uint64_t voff;
    if (s->content_addressed) {
      voff = off + 4;
    } else {
      if (rklen != klen) continue;
      std::vector<uint8_t> rkey(rklen);
      if (!read_exact(s->log, off + 2, rkey.data(), rklen)) continue;
      if (memcmp(rkey.data(), key, klen) != 0) continue;
      voff = off + 2 + rklen + 4;
    }
    std::vector<uint8_t> val(vlen);
    if (!read_exact(s->log, voff, val.data(), vlen)) continue;
    if (s->content_addressed) {
      // short-key collision guard: recompute the content address
      uint8_t digest[32];
      khipu_keccak(136, val.data(), vlen, digest, 32);
      if (klen != 32 || memcmp(digest, key, 32) != 0) continue;
    }
    if (vlen > cap) return (int64_t)vlen;  // caller retries with room
    memcpy(out, val.data(), vlen);
    return (int64_t)vlen;
  }
  return -1;
}

int kstore_put(void* handle, const uint8_t* key, uint32_t klen,
               const uint8_t* val, uint32_t vlen) {
  Store* s = (Store*)handle;
  if (s->content_addressed) {
    // dedup: content-addressed nodes are immutable; skip if present
    uint8_t probe[1];
    int64_t got = kstore_get(handle, key, klen, probe, 0);
    if (got >= 0) return 0;
  }
  fseeko(s->log, 0, SEEK_END);
  uint64_t off = s->log_len;
  bool ok;
  if (s->content_addressed) {
    ok = fwrite(&vlen, 4, 1, s->log) == 1 &&
         fwrite(val, 1, vlen, s->log) == vlen;
  } else {
    uint16_t k16 = (uint16_t)klen;
    ok = fwrite(&k16, 2, 1, s->log) == 1 &&
         fwrite(key, 1, klen, s->log) == klen &&
         fwrite(&vlen, 4, 1, s->log) == 1 &&
         fwrite(val, 1, vlen, s->log) == vlen;
  }
  if (!ok) {
    // disk full / IO error: roll the log back to the pre-write offset
    // so bookkeeping never diverges from the file, and surface -1
    fflush(s->log);
    (void)!ftruncate(fileno(s->log), (off_t)off);
    clearerr(s->log);
    return -1;
  }
  s->log_len = off + (s->content_addressed
                          ? 4 + (uint64_t)vlen
                          : 2 + (uint64_t)klen + 4 + (uint64_t)vlen);
  index_record(s, off, key, klen);
  uint64_t pair[2] = {short_key(key, klen), off};
  fseeko(s->idx, 0, SEEK_END);
  fwrite(pair, 8, 2, s->idx);
  return 0;
}

void kstore_flush(void* handle) {
  Store* s = (Store*)handle;
  fflush(s->log);
  s->indexed_len = s->log_len;
  write_idx_header(s);
}

uint64_t kstore_count(void* handle) { return ((Store*)handle)->count; }

int64_t kstore_max_key8(void* handle) { return ((Store*)handle)->max_key8; }

void kstore_close(void* handle) {
  Store* s = (Store*)handle;
  kstore_flush(handle);
  fclose(s->log);
  fclose(s->idx);
  delete s;
}

}  // extern "C"
