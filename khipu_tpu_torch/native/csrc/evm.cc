// Native EVM interpreter core.
//
// Role: the hot interpreter loop of khipu's VM
// (khipu-eth/src/main/scala/khipu/vm/VM.scala:14-60, OpCode.scala:211-1646,
// ProgramState.scala:29) rebuilt as a C++ core so transaction execution
// (a) runs at native speed and (b) releases the CPython GIL, giving the
// optimistic parallel executor (Ledger.scala:337-461 role) a real
// wall-clock multicore speedup — the reference's headline claim.
//
// Split of responsibilities (see khipu_tpu_torch/evm/native_vm.py):
//   * C++ owns: u256 arithmetic, stack/memory, gas accounting, the full
//     Frontier..Istanbul opcode set, nested call/create frames, and a
//     tx-scoped write OVERLAY for read-your-writes semantics.
//   * Python owns: underlying state (BlockWorldState) via read callbacks
//     (each callback lands on the world's RECORDING accessor, so the
//     parallel merge algebra's read sets stay exact), and precompiles.
//   * Writes are emitted as an OP LOG — the literal sequence of world
//     mutations (add_balance/save_storage/...) the Python VM would have
//     made, truncated when a frame reverts. The adapter replays the log
//     through the same BlockWorldState methods, so write-log / delta /
//     race-set semantics are bit-identical to the Python VM.
//
// Reads that hit the overlay (values this tx itself wrote) are NOT
// re-recorded as reads: a tx-internal observation cannot depend on an
// earlier parallel tx, so skipping the record is sound for the merge
// (it can only reduce false conflicts; see ledger/world.py merge()).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <array>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" void khipu_keccak(int rate, const uint8_t* in, uint64_t in_len,
                             uint8_t* out, int out_len);

namespace evm {

// ===================================================================== u256

struct U256 {
  uint64_t w[4] = {0, 0, 0, 0};  // little-endian limbs
};

static inline bool is_zero(const U256& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

static inline int ucmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i] ? -1 : 1;
  }
  return 0;
}

static inline bool eq(const U256& a, const U256& b) { return ucmp(a, b) == 0; }

static inline U256 from_u64(uint64_t x) {
  U256 r;
  r.w[0] = x;
  return r;
}

static inline U256 add(const U256& a, const U256& b) {
  U256 r;
  unsigned __int128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (unsigned __int128)a.w[i] + b.w[i];
    r.w[i] = (uint64_t)c;
    c >>= 64;
  }
  return r;
}

static inline U256 sub(const U256& a, const U256& b) {
  U256 r;
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 d =
        (unsigned __int128)a.w[i] - b.w[i] - (uint64_t)borrow;
    r.w[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return r;
}

static inline U256 neg(const U256& a) { return sub(U256{}, a); }

static inline U256 mul(const U256& a, const U256& b) {
  U256 r;
  for (int i = 0; i < 4; ++i) {
    if (a.w[i] == 0) continue;
    unsigned __int128 carry = 0;
    for (int j = 0; i + j < 4; ++j) {
      unsigned __int128 cur =
          (unsigned __int128)a.w[i] * b.w[j] + r.w[i + j] + carry;
      r.w[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
  }
  return r;
}

// full 256x256 -> 512 (for MULMOD)
static inline void mul_full(const U256& a, const U256& b, uint64_t out[8]) {
  std::memset(out, 0, 8 * sizeof(uint64_t));
  for (int i = 0; i < 4; ++i) {
    if (a.w[i] == 0) continue;
    unsigned __int128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      unsigned __int128 cur =
          (unsigned __int128)a.w[i] * b.w[j] + out[i + j] + carry;
      out[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    out[i + 4] = (uint64_t)carry;
  }
}

static inline int bit_length(const U256& a) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i]) return 64 * i + (64 - __builtin_clzll(a.w[i]));
  }
  return 0;
}

static inline U256 shl(const U256& a, unsigned s) {
  U256 r;
  if (s >= 256) return r;
  unsigned limb = s / 64, off = s % 64;
  for (int i = 3; i >= 0; --i) {
    uint64_t v = 0;
    int src = i - (int)limb;
    if (src >= 0) {
      v = a.w[src] << off;
      if (off && src - 1 >= 0) v |= a.w[src - 1] >> (64 - off);
    }
    r.w[i] = v;
  }
  return r;
}

static inline U256 shr(const U256& a, unsigned s) {
  U256 r;
  if (s >= 256) return r;
  unsigned limb = s / 64, off = s % 64;
  for (int i = 0; i < 4; ++i) {
    uint64_t v = 0;
    unsigned src = i + limb;
    if (src < 4) {
      v = a.w[src] >> off;
      if (off && src + 1 < 4) v |= a.w[src + 1] << (64 - off);
    }
    r.w[i] = v;
  }
  return r;
}

static inline bool sign_bit(const U256& a) { return (a.w[3] >> 63) != 0; }

static inline U256 sar(const U256& a, unsigned s) {
  bool negv = sign_bit(a);
  if (s >= 256) {
    U256 r;
    if (negv) r.w[0] = r.w[1] = r.w[2] = r.w[3] = ~0ULL;
    return r;
  }
  U256 r = shr(a, s);
  if (negv && s > 0) {
    // fill the vacated top s bits with ones
    U256 ones;
    ones.w[0] = ones.w[1] = ones.w[2] = ones.w[3] = ~0ULL;
    r = {r.w[0] | shl(ones, 256 - s).w[0], r.w[1] | shl(ones, 256 - s).w[1],
         r.w[2] | shl(ones, 256 - s).w[2], r.w[3] | shl(ones, 256 - s).w[3]};
  }
  return r;
}

// ---- division: generic little-endian base-2^32 digits (Knuth D) ----

static int digits_of(const uint64_t* limbs, int nlimbs, uint32_t* d) {
  int n = 0;
  for (int i = 0; i < nlimbs; ++i) {
    d[2 * i] = (uint32_t)limbs[i];
    d[2 * i + 1] = (uint32_t)(limbs[i] >> 32);
  }
  n = 2 * nlimbs;
  while (n > 0 && d[n - 1] == 0) --n;
  return n;
}

static void digits_to_u256(const uint32_t* d, int n, U256& out) {
  out = U256{};
  for (int i = 0; i < n && i < 8; ++i) {
    out.w[i / 2] |= (uint64_t)d[i] << (32 * (i % 2));
  }
}

// u[0..un-1] / v[0..vn-1]  ->  q[0..un-vn], r[0..vn-1]; vn>=1, v[vn-1]!=0
static void divmod_digits(const uint32_t* u_in, int un, const uint32_t* v_in,
                          int vn, uint32_t* q, uint32_t* r) {
  if (un < vn) {
    for (int i = 0; i < vn; ++i) r[i] = i < un ? u_in[i] : 0;
    return;  // q stays zero (caller pre-zeroes)
  }
  if (vn == 1) {
    uint64_t rem = 0, d = v_in[0];
    for (int i = un - 1; i >= 0; --i) {
      uint64_t cur = (rem << 32) | u_in[i];
      q[i] = (uint32_t)(cur / d);
      rem = cur % d;
    }
    r[0] = (uint32_t)rem;
    for (int i = 1; i < vn; ++i) r[i] = 0;
    return;
  }
  // normalize
  int s = __builtin_clz(v_in[vn - 1]);
  std::vector<uint32_t> v(vn), u(un + 1);
  for (int i = vn - 1; i > 0; --i)
    v[i] = (uint32_t)((v_in[i] << s) | (s ? (uint64_t)v_in[i - 1] >> (32 - s) : 0));
  v[0] = v_in[0] << s;
  u[un] = s ? (uint32_t)((uint64_t)u_in[un - 1] >> (32 - s)) : 0;
  for (int i = un - 1; i > 0; --i)
    u[i] = (uint32_t)((u_in[i] << s) | (s ? (uint64_t)u_in[i - 1] >> (32 - s) : 0));
  u[0] = u_in[0] << s;

  for (int j = un - vn; j >= 0; --j) {
    uint64_t top = ((uint64_t)u[j + vn] << 32) | u[j + vn - 1];
    uint64_t qhat = top / v[vn - 1];
    uint64_t rhat = top % v[vn - 1];
    while (qhat > 0xFFFFFFFFull ||
           (unsigned __int128)qhat * v[vn - 2] >
               (((unsigned __int128)rhat << 32) | u[j + vn - 2])) {
      --qhat;
      rhat += v[vn - 1];
      if (rhat > 0xFFFFFFFFull) break;
    }
    // multiply-subtract
    int64_t borrow = 0;
    uint64_t carry = 0;
    for (int i = 0; i < vn; ++i) {
      uint64_t p = qhat * v[i] + carry;
      carry = p >> 32;
      int64_t t = (int64_t)u[i + j] - (int64_t)(uint32_t)p - borrow;
      u[i + j] = (uint32_t)t;
      borrow = t < 0 ? 1 : 0;
    }
    int64_t t = (int64_t)u[j + vn] - (int64_t)carry - borrow;
    u[j + vn] = (uint32_t)t;
    if (t < 0) {
      // add back
      --qhat;
      uint64_t c = 0;
      for (int i = 0; i < vn; ++i) {
        uint64_t sum = (uint64_t)u[i + j] + v[i] + c;
        u[i + j] = (uint32_t)sum;
        c = sum >> 32;
      }
      u[j + vn] = (uint32_t)((uint64_t)u[j + vn] + c);
    }
    q[j] = (uint32_t)qhat;
  }
  // denormalize remainder
  for (int i = 0; i < vn - 1; ++i)
    r[i] = (uint32_t)((u[i] >> s) | (s ? (uint64_t)u[i + 1] << (32 - s) : 0));
  r[vn - 1] = u[vn - 1] >> s;
}

static void udivmod(const U256& a, const U256& b, U256& q, U256& r) {
  uint32_t ud[8], vd[8], qd[9] = {0}, rd[8] = {0};
  int un = digits_of(a.w, 4, ud);
  int vn = digits_of(b.w, 4, vd);
  if (vn == 0) {  // div by zero -> 0,0 (EVM semantics)
    q = U256{};
    r = U256{};
    return;
  }
  if (un == 0) {
    q = U256{};
    r = U256{};
    return;
  }
  divmod_digits(ud, un, vd, vn, qd, rd);
  digits_to_u256(qd, un >= vn ? un - vn + 1 : 0, q);
  digits_to_u256(rd, vn, r);
}

// 512 % 256 (for MULMOD)
static U256 mod512(const uint64_t prod[8], const U256& m) {
  uint32_t ud[16], vd[8], qd[17] = {0}, rd[8] = {0};
  int un = digits_of(prod, 8, ud);
  int vn = digits_of(m.w, 4, vd);
  U256 r{};
  if (vn == 0 || un == 0) return r;
  divmod_digits(ud, un, vd, vn, qd, rd);
  digits_to_u256(rd, vn, r);
  return r;
}

static U256 sdiv(const U256& a, const U256& b) {
  if (is_zero(b)) return U256{};
  bool na = sign_bit(a), nb = sign_bit(b);
  U256 ua = na ? neg(a) : a, ub = nb ? neg(b) : b, q, r;
  udivmod(ua, ub, q, r);
  return (na != nb) ? neg(q) : q;
}

static U256 smod(const U256& a, const U256& b) {
  if (is_zero(b)) return U256{};
  bool na = sign_bit(a), nb = sign_bit(b);
  U256 ua = na ? neg(a) : a, ub = nb ? neg(b) : b, q, r;
  udivmod(ua, ub, q, r);
  return na ? neg(r) : r;
}

static U256 uexp(const U256& base, const U256& e) {
  U256 result = from_u64(1), b = base;
  int bits = bit_length(e);
  for (int i = 0; i < bits; ++i) {
    if ((e.w[i / 64] >> (i % 64)) & 1) result = mul(result, b);
    b = mul(b, b);
  }
  return result;
}

static U256 signextend(const U256& k, const U256& x) {
  if (k.w[1] | k.w[2] | k.w[3] || k.w[0] >= 31) return x;
  unsigned bit = 8 * ((unsigned)k.w[0] + 1) - 1;
  bool set = (x.w[bit / 64] >> (bit % 64)) & 1;
  U256 r = x;
  for (unsigned i = bit + 1; i < 256; ++i) {
    if (set)
      r.w[i / 64] |= 1ULL << (i % 64);
    else
      r.w[i / 64] &= ~(1ULL << (i % 64));
  }
  return r;
}

static U256 byte_at(const U256& i, const U256& x) {
  if (i.w[1] | i.w[2] | i.w[3] || i.w[0] >= 32) return U256{};
  unsigned shift = 8 * (31 - (unsigned)i.w[0]);
  U256 t = shr(x, shift);
  return from_u64(t.w[0] & 0xFF);
}

static inline void to_be32(const U256& a, uint8_t out[32]) {
  for (int i = 0; i < 4; ++i) {
    uint64_t w = a.w[3 - i];
    for (int j = 0; j < 8; ++j) out[8 * i + j] = (uint8_t)(w >> (8 * (7 - j)));
  }
}

static inline U256 from_be(const uint8_t* b, size_t len) {
  U256 r;
  if (len > 32) {
    b += len - 32;
    len = 32;
  }
  for (size_t i = 0; i < len; ++i) {
    size_t bit = 8 * (len - 1 - i);
    r.w[bit / 64] |= (uint64_t)b[i] << (bit % 64);
  }
  return r;
}

static inline uint64_t sat_u64(const U256& a) {
  return (a.w[1] | a.w[2] | a.w[3]) ? ~0ULL : a.w[0];
}

// ================================================================== ABI

using Addr = std::array<uint8_t, 20>;
using B32 = std::array<uint8_t, 32>;

struct AddrHash {
  size_t operator()(const Addr& a) const {
    uint64_t h = 1469598103934665603ULL;
    for (uint8_t c : a) h = (h ^ c) * 1099511628211ULL;
    return (size_t)h;
  }
};

struct SKey {  // (address, storage slot)
  Addr a;
  B32 k;
  bool operator==(const SKey& o) const { return a == o.a && k == o.k; }
};

struct SKeyHash {
  size_t operator()(const SKey& s) const {
    uint64_t h = 1469598103934665603ULL;
    for (uint8_t c : s.a) h = (h ^ c) * 1099511628211ULL;
    for (uint8_t c : s.k) h = (h ^ c) * 1099511628211ULL;
    return (size_t)h;
  }
};

// fee schedule indices — MUST match FEE_FIELDS in native_vm.py
enum Fee {
  F_zero, F_base, F_verylow, F_low, F_mid, F_high, F_balance, F_sload,
  F_jumpdest, F_sset, F_sreset, F_r_sclear, F_r_selfdestruct,
  F_selfdestruct, F_create, F_codedeposit, F_call, F_callvalue,
  F_callstipend, F_newaccount, F_exp, F_expbyte, F_memory, F_txcreate,
  F_txdatazero, F_txdatanonzero, F_transaction, F_log, F_logdata,
  F_logtopic, F_sha3, F_sha3word, F_copy, F_blockhash, F_extcode,
  F_extcodehash, F_sstore_noop, F_sstore_init, F_sstore_clean,
  F_sstore_sentry, F_COUNT
};

// cfg u64 array layout — MUST match native_vm.py pack_config
enum Cfg {
  C_chain_id, C_start_nonce, C_contract_start_nonce, C_max_code_size,
  C_homestead, C_eip150, C_eip161, C_eip170, C_byzantium,
  C_constantinople, C_istanbul, C_eip161_patch, C_FEES0  // fees follow
};

typedef int (*cb_exists_t)(void*, const uint8_t*);
typedef int (*cb_is_dead_t)(void*, const uint8_t*);
typedef void (*cb_get_account_t)(void*, const uint8_t*, uint8_t*);  // out[73]
typedef void (*cb_get_code_hash_t)(void*, const uint8_t*, uint8_t*);
typedef void (*cb_get_code_t)(void*, const uint8_t*, const uint8_t**,
                              uint64_t*);
typedef void (*cb_get_storage_t)(void*, const uint8_t*, const uint8_t*,
                                 uint8_t*);
typedef int (*cb_blockhash_t)(void*, uint64_t, uint8_t*);
typedef int (*cb_precompile_t)(void*, uint32_t, const uint8_t*, uint64_t,
                               uint64_t, const uint8_t**, uint64_t*,
                               uint64_t*);

struct Callbacks {  // unpacked from the void*[9] the adapter passes
  void* h;
  cb_exists_t exists;
  cb_is_dead_t is_dead;
  cb_get_account_t get_account;
  cb_get_code_hash_t get_code_hash;
  cb_get_code_t get_code;
  cb_get_storage_t get_storage;
  cb_get_storage_t get_original;
  cb_blockhash_t blockhash;
  cb_precompile_t precompile;
};

struct BlockCtx {
  uint64_t number, timestamp, gas_limit;
  U256 difficulty;
  Addr beneficiary;
};

// error codes (native_vm.py maps these to the Python VM's error strings)
enum Err {
  OK = 0, REVERT = 1, E_OOG = 2, E_STACK_UNDER = 3, E_STACK_OVER = 4,
  E_INVALID_OP = 5, E_INVALID_JUMP = 6, E_STATIC = 7, E_RETURNDATA = 8,
  E_COLLISION = 9, E_CODE_SIZE = 10, E_DEPOSIT_OOG = 11,
  E_PRECOMPILE = 12, E_PRECOMPILE_OOG = 13, E_DEPTH = 14
};

struct VmError {
  int code;
  explicit VmError(int c) : code(c) {}
};

// op log opcodes — MUST match native_vm.py _replay_oplog
enum WOp {
  W_ADD_BALANCE = 1, W_INC_NONCE = 2, W_SAVE_STORAGE = 3, W_SAVE_CODE = 4,
  W_CREATE_ACCOUNT = 5, W_INIT_IF_MISSING = 6, W_TRANSFER = 7, W_TOUCH = 8,
  W_SD_MARK = 9, W_LOG = 10
};

// ============================================================= overlay

struct AcctW {
  bool has_abs = false;        // absolute account value known (create/init)
  uint64_t abs_nonce = 0;
  U256 abs_balance{};
  bool storage_cleared = false;  // CREATE wiped the storage view
  U256 bal_delta{};              // wrapping mod 2^256 (two's complement)
  uint64_t nonce_delta = 0;
  bool code_set = false;
  uint32_t code_idx = 0;  // into TxCtx::code_arena
  bool any_delta() const { return nonce_delta != 0 || !is_zero(bal_delta); }
};

struct FrameState {  // copied at call-frame boundaries (world.copy() role)
  std::unordered_map<Addr, AcctW, AddrHash> accts;
  std::unordered_map<SKey, U256, SKeyHash> storage;
  std::set<Addr> selfdestructed;
};

struct BaseAcct {
  bool exists;
  uint64_t nonce;
  U256 balance;
  B32 code_hash;
};

struct TxCtx {
  const uint64_t* cfg;
  Callbacks cb;
  BlockCtx blk;
  std::vector<uint8_t> oplog;
  std::vector<std::vector<uint8_t>> code_arena;
  // base caches: the underlying Python world is immutable during the
  // native call (all writes stay in the overlay), so caching is sound.
  std::unordered_map<Addr, BaseAcct, AddrHash> base_acct;
  std::unordered_map<Addr, B32, AddrHash> base_codehash;
  std::unordered_map<Addr, std::pair<const uint8_t*, uint64_t>, AddrHash>
      base_code;
  std::unordered_map<SKey, U256, SKeyHash> base_storage;
  std::unordered_map<SKey, U256, SKeyHash> base_original;
  std::unordered_map<Addr, bool, AddrHash> base_exists;
  std::unordered_map<Addr, bool, AddrHash> base_dead;
  FrameState frame;

  uint64_t fee(int f) const { return cfg[C_FEES0 + f]; }
  bool flag(int c) const { return cfg[c] != 0; }
};

// ------------------------------------------------------- oplog writers

static void put_u32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((uint8_t)x);
  v.push_back((uint8_t)(x >> 8));
  v.push_back((uint8_t)(x >> 16));
  v.push_back((uint8_t)(x >> 24));
}

static void put_u64(std::vector<uint8_t>& v, uint64_t x) {
  put_u32(v, (uint32_t)x);
  put_u32(v, (uint32_t)(x >> 32));
}

static void put_addr(std::vector<uint8_t>& v, const Addr& a) {
  v.insert(v.end(), a.begin(), a.end());
}

static void put_b32(std::vector<uint8_t>& v, const U256& x) {
  uint8_t buf[32];
  to_be32(x, buf);
  v.insert(v.end(), buf, buf + 32);
}

// -------------------------------------------------------- read helpers

static const BaseAcct& base_account(TxCtx& tx, const Addr& a) {
  auto it = tx.base_acct.find(a);
  if (it != tx.base_acct.end()) return it->second;
  uint8_t out[73];
  tx.cb.get_account(tx.cb.h, a.data(), out);  // records ON_ACCOUNT read
  BaseAcct b;
  b.exists = out[0] != 0;
  b.nonce = 0;
  for (int i = 0; i < 8; ++i) b.nonce |= (uint64_t)out[1 + i] << (8 * i);
  b.balance = from_be(out + 9, 32);
  std::memcpy(b.code_hash.data(), out + 41, 32);
  return tx.base_acct.emplace(a, b).first->second;
}

static U256 r_balance(TxCtx& tx, const Addr& a) {
  auto it = tx.frame.accts.find(a);
  U256 base{};
  if (it != tx.frame.accts.end() && it->second.has_abs) {
    base = it->second.abs_balance;
  } else {
    const BaseAcct& b = base_account(tx, a);
    if (b.exists) base = b.balance;
  }
  if (it != tx.frame.accts.end()) base = add(base, it->second.bal_delta);
  return base;
}

static uint64_t r_nonce(TxCtx& tx, const Addr& a) {
  auto it = tx.frame.accts.find(a);
  uint64_t base;
  if (it != tx.frame.accts.end() && it->second.has_abs) {
    base = it->second.abs_nonce;
  } else {
    const BaseAcct& b = base_account(tx, a);
    base = b.exists ? b.nonce : tx.cfg[C_start_nonce];
  }
  if (it != tx.frame.accts.end()) base += it->second.nonce_delta;
  return base;
}

static bool r_exists(TxCtx& tx, const Addr& a) {
  auto it = tx.frame.accts.find(a);
  if (it != tx.frame.accts.end()) {
    if (it->second.has_abs) return true;
    // a nonzero positive delta materializes the account (world.py
    // _current_account: delta with nonce|balance conjures it)
    if (it->second.any_delta() && !sign_bit(it->second.bal_delta)) return true;
  }
  auto c = tx.base_exists.find(a);
  if (c != tx.base_exists.end()) return c->second;
  bool v = tx.cb.exists(tx.cb.h, a.data()) != 0;  // records ON_ADDRESS
  tx.base_exists.emplace(a, v);
  return v;
}

static const std::vector<uint8_t>* overlay_code(TxCtx& tx, const Addr& a) {
  auto it = tx.frame.accts.find(a);
  if (it != tx.frame.accts.end() && it->second.code_set)
    return &tx.code_arena[it->second.code_idx];
  return nullptr;
}

static void r_code(TxCtx& tx, const Addr& a, const uint8_t** p, uint64_t* n) {
  if (const auto* c = overlay_code(tx, a)) {
    *p = c->data();
    *n = c->size();
    return;
  }
  auto it = tx.frame.accts.find(a);
  if (it != tx.frame.accts.end() && it->second.has_abs) {
    *p = nullptr;
    *n = 0;  // created/initialized empty account: no code
    return;
  }
  auto c = tx.base_code.find(a);
  if (c != tx.base_code.end()) {
    *p = c->second.first;
    *n = c->second.second;
    return;
  }
  const uint8_t* ptr = nullptr;
  uint64_t len = 0;
  tx.cb.get_code(tx.cb.h, a.data(), &ptr, &len);  // records ON_CODE
  tx.base_code.emplace(a, std::make_pair(ptr, len));
  *p = ptr;
  *n = len;
}

static const uint8_t EMPTY_HASH[32] = {
    0xc5, 0xd2, 0x46, 0x01, 0x86, 0xf7, 0x23, 0x3c, 0x92, 0x7e, 0x7d,
    0xb2, 0xdc, 0xc7, 0x03, 0xc0, 0xe5, 0x00, 0xb6, 0x53, 0xca, 0x82,
    0x27, 0x3b, 0x7b, 0xfa, 0xd8, 0x04, 0x5d, 0x85, 0xa4, 0x70};

static void r_code_hash(TxCtx& tx, const Addr& a, uint8_t out[32]) {
  if (const auto* c = overlay_code(tx, a)) {
    if (c->empty())
      std::memcpy(out, EMPTY_HASH, 32);
    else
      khipu_keccak(136, c->data(), c->size(), out, 32);
    return;
  }
  auto it = tx.frame.accts.find(a);
  if (it != tx.frame.accts.end() && it->second.has_abs) {
    std::memcpy(out, EMPTY_HASH, 32);
    return;
  }
  auto c = tx.base_codehash.find(a);
  if (c != tx.base_codehash.end()) {
    std::memcpy(out, c->second.data(), 32);
    return;
  }
  B32 h;
  tx.cb.get_code_hash(tx.cb.h, a.data(), h.data());  // records ON_CODE
  tx.base_codehash.emplace(a, h);
  std::memcpy(out, h.data(), 32);
}

static bool r_dead(TxCtx& tx, const Addr& a) {
  auto it = tx.frame.accts.find(a);
  if (it != tx.frame.accts.end()) {
    const AcctW& w = it->second;
    if (w.has_abs) {
      uint64_t nonce = w.abs_nonce + w.nonce_delta;
      U256 bal = add(w.abs_balance, w.bal_delta);
      bool code_empty = true;
      if (w.code_set) code_empty = tx.code_arena[w.code_idx].empty();
      return nonce == tx.cfg[C_start_nonce] && is_zero(bal) && code_empty;
    }
    if (w.any_delta() && !sign_bit(w.bal_delta)) return false;
  }
  auto c = tx.base_dead.find(a);
  if (c != tx.base_dead.end()) return c->second;
  bool v = tx.cb.is_dead(tx.cb.h, a.data()) != 0;  // records both reads
  tx.base_dead.emplace(a, v);
  return v;
}

static U256 r_storage(TxCtx& tx, const Addr& a, const U256& key) {
  SKey sk;
  sk.a = a;
  to_be32(key, sk.k.data());
  auto it = tx.frame.storage.find(sk);
  if (it != tx.frame.storage.end()) return it->second;
  auto ac = tx.frame.accts.find(a);
  if (ac != tx.frame.accts.end() && ac->second.storage_cleared) return U256{};
  auto c = tx.base_storage.find(sk);
  if (c != tx.base_storage.end()) return c->second;
  uint8_t out[32];
  tx.cb.get_storage(tx.cb.h, a.data(), sk.k.data(), out);  // ON_STORAGE
  U256 v = from_be(out, 32);
  tx.base_storage.emplace(sk, v);
  return v;
}

static U256 r_original(TxCtx& tx, const Addr& a, const U256& key) {
  SKey sk;
  sk.a = a;
  to_be32(key, sk.k.data());
  auto ac = tx.frame.accts.find(a);
  if (ac != tx.frame.accts.end() && ac->second.storage_cleared) return U256{};
  auto c = tx.base_original.find(sk);
  if (c != tx.base_original.end()) return c->second;
  uint8_t out[32];
  tx.cb.get_original(tx.cb.h, a.data(), sk.k.data(), out);  // ON_STORAGE
  U256 v = from_be(out, 32);
  tx.base_original.emplace(sk, v);
  return v;
}

// -------------------------------------------------------- write helpers
// Each mirrors one BlockWorldState mutator: update the overlay AND emit
// the op so the adapter replays the identical call sequence.

static void w_add_balance(TxCtx& tx, const Addr& a, const U256& amt,
                          bool negative) {
  AcctW& w = tx.frame.accts[a];
  w.bal_delta = negative ? sub(w.bal_delta, amt) : add(w.bal_delta, amt);
  tx.oplog.push_back(W_ADD_BALANCE);
  put_addr(tx.oplog, a);
  tx.oplog.push_back(negative ? 1 : 0);
  put_b32(tx.oplog, amt);
}

static void w_inc_nonce(TxCtx& tx, const Addr& a) {
  tx.frame.accts[a].nonce_delta += 1;
  tx.oplog.push_back(W_INC_NONCE);
  put_addr(tx.oplog, a);
  put_u64(tx.oplog, 1);
}

static void w_save_storage(TxCtx& tx, const Addr& a, const U256& key,
                           const U256& val) {
  SKey sk;
  sk.a = a;
  to_be32(key, sk.k.data());
  tx.frame.storage[sk] = val;
  tx.oplog.push_back(W_SAVE_STORAGE);
  put_addr(tx.oplog, a);
  tx.oplog.insert(tx.oplog.end(), sk.k.begin(), sk.k.end());
  put_b32(tx.oplog, val);
}

static void w_save_code(TxCtx& tx, const Addr& a, const uint8_t* code,
                        uint64_t len) {
  AcctW& w = tx.frame.accts[a];
  w.code_set = true;
  w.code_idx = (uint32_t)tx.code_arena.size();
  tx.code_arena.emplace_back(code, code + len);
  tx.oplog.push_back(W_SAVE_CODE);
  put_addr(tx.oplog, a);
  put_u32(tx.oplog, (uint32_t)len);
  tx.oplog.insert(tx.oplog.end(), code, code + len);
}

static void w_create_account(TxCtx& tx, const Addr& a, uint64_t nonce,
                             const U256& balance) {
  AcctW& w = tx.frame.accts[a];
  w.has_abs = true;
  w.abs_nonce = nonce;
  w.abs_balance = balance;
  w.storage_cleared = true;
  w.bal_delta = U256{};
  w.nonce_delta = 0;
  // world.create_account sets codes[addr] = b""
  w.code_set = true;
  w.code_idx = (uint32_t)tx.code_arena.size();
  tx.code_arena.emplace_back();
  // wipe frame-local storage writes for a (fresh TrieStorage)
  for (auto it = tx.frame.storage.begin(); it != tx.frame.storage.end();) {
    if (it->first.a == a)
      it = tx.frame.storage.erase(it);
    else
      ++it;
  }
  tx.oplog.push_back(W_CREATE_ACCOUNT);
  put_addr(tx.oplog, a);
  put_u64(tx.oplog, nonce);
  put_b32(tx.oplog, balance);
}

static void w_init_if_missing(TxCtx& tx, const Addr& a) {
  if (!r_exists(tx, a)) {  // records ON_ADDRESS read, like the Python
    AcctW& w = tx.frame.accts[a];
    w.has_abs = true;
    w.abs_nonce = tx.cfg[C_start_nonce];
    w.abs_balance = U256{};
  }
  tx.oplog.push_back(W_INIT_IF_MISSING);
  put_addr(tx.oplog, a);
}

static void w_transfer(TxCtx& tx, const Addr& from, const Addr& to,
                       const U256& value) {
  if (!is_zero(value) && from != to) {
    tx.frame.accts[from].bal_delta = sub(tx.frame.accts[from].bal_delta, value);
    tx.frame.accts[to].bal_delta = add(tx.frame.accts[to].bal_delta, value);
  }
  tx.oplog.push_back(W_TRANSFER);
  put_addr(tx.oplog, from);
  put_addr(tx.oplog, to);
  put_b32(tx.oplog, value);
}

static void w_touch(TxCtx& tx, const Addr& a) {
  tx.oplog.push_back(W_TOUCH);
  put_addr(tx.oplog, a);
}

static void w_sd_mark(TxCtx& tx, const Addr& a) {
  tx.frame.selfdestructed.insert(a);
  tx.oplog.push_back(W_SD_MARK);
  put_addr(tx.oplog, a);
}

static void w_log(TxCtx& tx, const Addr& a, const U256* topics, int ntopics,
                  const uint8_t* data, uint64_t dlen) {
  tx.oplog.push_back(W_LOG);
  put_addr(tx.oplog, a);
  tx.oplog.push_back((uint8_t)ntopics);
  for (int i = 0; i < ntopics; ++i) put_b32(tx.oplog, topics[i]);
  put_u32(tx.oplog, (uint32_t)dlen);
  tx.oplog.insert(tx.oplog.end(), data, data + dlen);
}

// ============================================================ interpreter

struct Mem {
  std::vector<uint8_t> data;
  uint64_t active_words = 0;

  void expand(uint64_t off, uint64_t size) {
    if (size == 0) return;
    uint64_t words = (off + size + 31) / 32;
    if (words > active_words) active_words = words;
    uint64_t need = words * 32;
    if (data.size() < need) data.resize(need, 0);
  }
  void store(uint64_t off, const uint8_t* src, uint64_t n) {
    expand(off, n);
    if (n) std::memcpy(data.data() + off, src, n);
  }
  void load(uint64_t off, uint64_t n, std::vector<uint8_t>& out) {
    if (n == 0) {  // zero-size loads never expand; off may be huge
      out.clear();
      return;
    }
    expand(off, n);
    out.assign(data.begin() + off, data.begin() + off + n);
  }
};

static const uint64_t MEM_WORD_CAP = 1ULL << 40;  // beyond this, cost > any gas

// word count after touching [off, off+size); saturating
static uint64_t words_after(uint64_t cur, const U256& off, const U256& size) {
  if (is_zero(size)) return cur;
  if ((off.w[1] | off.w[2] | off.w[3]) || (size.w[1] | size.w[2] | size.w[3]))
    return MEM_WORD_CAP;
  unsigned __int128 end = (unsigned __int128)off.w[0] + size.w[0] + 31;
  uint64_t words = (uint64_t)(end / 32);
  if (words > MEM_WORD_CAP) return MEM_WORD_CAP;
  return cur > words ? cur : words;
}

static unsigned __int128 mem_cost_words(uint64_t words, uint64_t g_memory) {
  return (unsigned __int128)g_memory * words +
         ((unsigned __int128)words * words) / 512;
}

struct Frame {
  TxCtx& tx;
  // message env
  Addr owner, caller, origin;
  U256 gas_price, value;
  const uint8_t* input;
  uint64_t input_len;
  uint32_t depth;
  bool is_static;
  // interpreter state
  const uint8_t* code;
  uint64_t code_len;
  int64_t gas;
  uint64_t pc = 0;
  std::vector<U256> stack;
  Mem mem;
  std::vector<uint8_t> returndata;
  std::vector<uint8_t> output;
  int64_t refund = 0;
  bool halted = false, reverted = false;
  std::vector<uint8_t> jumpdest_bits;

  Frame(TxCtx& t) : tx(t) { stack.reserve(64); }

  void analyze_jumpdests() {
    jumpdest_bits.assign((code_len + 7) / 8, 0);
    for (uint64_t i = 0; i < code_len;) {
      uint8_t op = code[i];
      if (op == 0x5B) {
        jumpdest_bits[i / 8] |= 1 << (i % 8);
        ++i;
      } else if (op >= 0x60 && op <= 0x7F) {
        i += op - 0x60 + 2;
      } else {
        ++i;
      }
    }
  }
  bool valid_jumpdest(uint64_t d) const {
    return d < code_len && (jumpdest_bits[d / 8] >> (d % 8)) & 1;
  }

  void charge(unsigned __int128 cost) {
    if (cost > (unsigned __int128)gas) throw VmError(E_OOG);
    gas -= (int64_t)cost;
  }
  uint64_t fee(int f) const { return tx.fee(f); }

  void push(const U256& v) {
    if (stack.size() >= 1024) throw VmError(E_STACK_OVER);
    stack.push_back(v);
  }
  U256 pop() {
    if (stack.empty()) throw VmError(E_STACK_UNDER);
    U256 v = stack.back();
    stack.pop_back();
    return v;
  }
  // expansion gas for touching [off, off+size)
  unsigned __int128 mem_gas(const U256& off, const U256& size) {
    uint64_t nw = words_after(mem.active_words, off, size);
    if (nw <= mem.active_words) return 0;
    uint64_t g = fee(F_memory);
    return mem_cost_words(nw, g) - mem_cost_words(mem.active_words, g);
  }
};

struct RunResult {
  int status = OK;  // OK / REVERT / error code
  int64_t gas_remaining = 0;
  int64_t refund = 0;
  std::vector<uint8_t> output;
};

static Addr to_addr(const U256& w) {
  Addr a;
  uint8_t b[32];
  to_be32(w, b);
  std::memcpy(a.data(), b + 12, 20);
  return a;
}

static U256 addr_to_word(const Addr& a) { return from_be(a.data(), 20); }

struct MsgEnv {
  Addr owner, caller, origin;
  U256 gas_price, value;
  const uint8_t* input;
  uint64_t input_len;
  uint32_t depth;
  bool is_static;
};

static RunResult run_frame(TxCtx& tx, const MsgEnv& env, const uint8_t* code,
                           uint64_t code_len, int64_t gas);
static RunResult execute_message(TxCtx& tx, const MsgEnv& env,
                                 const uint8_t* code, uint64_t code_len,
                                 int64_t gas, const Addr& code_addr);
static RunResult create_contract(TxCtx& tx, const Addr& caller,
                                 const Addr& origin, const Addr& new_addr,
                                 int64_t gas, const U256& gas_price,
                                 const U256& value, const uint8_t* init_code,
                                 uint64_t init_len, uint32_t depth);

// is `a` a precompile address under this config? returns 0 if not, else 1..9
static uint32_t precompile_id(const TxCtx& tx, const Addr& a) {
  for (int i = 0; i < 19; ++i)
    if (a[i] != 0) return 0;
  uint8_t last = a[19];
  if (last >= 1 && last <= 4) return last;
  if (last >= 5 && last <= 8) return tx.flag(C_byzantium) ? last : 0;
  if (last == 9) return tx.flag(C_istanbul) ? last : 0;
  return 0;
}

// minimal RLP of [addr20, minimal_nonce] for CREATE address derivation
static void create_address(const Addr& sender, uint64_t nonce, Addr& out) {
  uint8_t payload[32];
  int n = 0;
  payload[n++] = 0x80 + 20;
  std::memcpy(payload + n, sender.data(), 20);
  n += 20;
  if (nonce == 0) {
    payload[n++] = 0x80;
  } else if (nonce < 0x80) {
    payload[n++] = (uint8_t)nonce;
  } else {
    uint8_t tmp[8];
    int len = 0;
    for (int i = 7; i >= 0; --i) {
      uint8_t b = (uint8_t)(nonce >> (8 * i));
      if (len == 0 && b == 0) continue;
      tmp[len++] = b;
    }
    payload[n++] = 0x80 + len;
    std::memcpy(payload + n, tmp, len);
    n += len;
  }
  uint8_t rlp[40];
  rlp[0] = 0xC0 + n;
  std::memcpy(rlp + 1, payload, n);
  uint8_t h[32];
  khipu_keccak(136, rlp, n + 1, h, 32);
  std::memcpy(out.data(), h + 12, 20);
}

static void create2_address(const Addr& sender, const U256& salt,
                            const uint8_t* init, uint64_t init_len,
                            Addr& out) {
  uint8_t ih[32];
  khipu_keccak(136, init, init_len, ih, 32);
  uint8_t buf[85];
  buf[0] = 0xFF;
  std::memcpy(buf + 1, sender.data(), 20);
  to_be32(salt, buf + 21);
  std::memcpy(buf + 53, ih, 32);
  uint8_t h[32];
  khipu_keccak(136, buf, 85, h, 32);
  std::memcpy(out.data(), h + 12, 20);
}

// 63/64 rule (EvmConfig sub_gas_cap_divisor); charges the child gas
static int64_t consume_child_gas(Frame& f, const U256& requested) {
  uint64_t req = sat_u64(requested);
  int64_t child;
  if (f.tx.flag(C_eip150)) {
    int64_t cap = f.gas - f.gas / 64;
    child = req < (uint64_t)cap ? (int64_t)req : cap;
  } else {
    if (req > (uint64_t)f.gas) throw VmError(E_OOG);
    child = (int64_t)req;
  }
  f.charge((unsigned __int128)child);
  return child;
}

// CALL-family postlude (vm.py _finish_child)
static void finish_child(Frame& f, RunResult& r, uint64_t out_off,
                         uint64_t out_size) {
  bool byz = f.tx.flag(C_byzantium);
  if (r.status == OK || r.status == REVERT) {
    if (!r.output.empty() && out_size) {
      uint64_t n = r.output.size() < out_size ? r.output.size() : out_size;
      std::memcpy(f.mem.data.data() + out_off, r.output.data(), n);
    }
    f.gas += r.gas_remaining;
    if (r.status == OK) {
      f.refund += r.refund;
      f.push(from_u64(1));
    } else {
      f.push(U256{});
    }
    if (byz) f.returndata = r.output;
  } else {
    f.push(U256{});
    if (byz) f.returndata.clear();
  }
}

enum CallKind { K_CALL, K_CALLCODE, K_DELEGATE, K_STATIC };

static void op_call_family(Frame& f, CallKind kind) {
  TxCtx& tx = f.tx;
  bool has_value = (kind == K_CALL || kind == K_CALLCODE);
  U256 gas_req = f.pop();
  Addr to = to_addr(f.pop());
  U256 value = has_value ? f.pop() : U256{};
  U256 in_off_w = f.pop(), in_size_w = f.pop();
  U256 out_off_w = f.pop(), out_size_w = f.pop();

  if (kind == K_CALL && !is_zero(value) && f.is_static)
    throw VmError(E_STATIC);

  unsigned __int128 cost = f.fee(F_call);
  if (has_value && !is_zero(value)) cost += f.fee(F_callvalue);
  if (kind == K_CALL) {
    if (tx.flag(C_eip161)) {
      if (!is_zero(value) && r_dead(tx, to)) cost += f.fee(F_newaccount);
    } else if (!r_exists(tx, to)) {
      cost += f.fee(F_newaccount);
    }
  }
  cost += f.mem_gas(in_off_w, in_size_w);
  // output expansion relative to post-input memory (vm.py quirk kept)
  uint64_t mem_after_in = words_after(f.mem.active_words, in_off_w, in_size_w);
  if (!is_zero(out_size_w)) {
    uint64_t out_words = words_after(0, out_off_w, out_size_w);
    if (out_words > mem_after_in) {
      uint64_t g = f.fee(F_memory);
      cost += mem_cost_words(out_words, g) - mem_cost_words(mem_after_in, g);
    }
  }
  f.charge(cost);
  int64_t child_gas = consume_child_gas(f, gas_req);
  if (has_value && !is_zero(value)) child_gas += (int64_t)f.fee(F_callstipend);

  uint64_t in_off = sat_u64(in_off_w), in_size = sat_u64(in_size_w);
  uint64_t out_off = sat_u64(out_off_w), out_size = sat_u64(out_size_w);
  f.mem.expand(in_off, in_size);
  f.mem.expand(out_off, out_size);
  std::vector<uint8_t> input;
  f.mem.load(in_off, in_size, input);

  bool byz = tx.flag(C_byzantium);
  if (f.depth + 1 > 1024 ||
      (has_value && !is_zero(value) &&
       ucmp(r_balance(tx, f.owner), value) < 0)) {
    f.gas += child_gas;  // child never ran
    f.push(U256{});
    if (byz) f.returndata.clear();
    f.pc += 1;
    return;
  }

  FrameState saved = tx.frame;  // world.copy() at the call boundary
  size_t oplog_mark = tx.oplog.size();

  MsgEnv env;
  env.origin = f.origin;
  env.gas_price = f.gas_price;
  env.input = input.data();
  env.input_len = input.size();
  env.depth = f.depth + 1;
  if (kind == K_CALL) {
    if (!tx.flag(C_eip161)) w_init_if_missing(tx, to);
    w_transfer(tx, f.owner, to, value);
    w_touch(tx, to);
    env.owner = to;
    env.caller = f.owner;
    env.value = value;
    env.is_static = f.is_static;
  } else if (kind == K_CALLCODE) {
    env.owner = f.owner;
    env.caller = f.owner;
    env.value = value;
    env.is_static = f.is_static;
  } else if (kind == K_DELEGATE) {
    env.owner = f.owner;
    env.caller = f.caller;
    env.value = f.value;
    env.is_static = f.is_static;
  } else {  // STATICCALL
    w_touch(tx, to);
    env.owner = to;
    env.caller = f.owner;
    env.value = U256{};
    env.is_static = true;
  }
  const uint8_t* code = nullptr;
  uint64_t code_len = 0;
  r_code(tx, to, &code, &code_len);
  RunResult r = execute_message(tx, env, code, code_len, child_gas, to);
  if (r.status != OK) {  // revert or error: discard the child's writes
    tx.frame = std::move(saved);
    tx.oplog.resize(oplog_mark);
    // mainnet #2,675,119 compat (OpCode.scala:1425-1436): a failed
    // call to the ripemd precompile keeps its touch in the parent
    if (tx.flag(C_eip161_patch)) {
      bool is_ripemd = to[19] == 0x03;
      for (int i = 0; i < 19 && is_ripemd; ++i)
        if (to[i] != 0) is_ripemd = false;
      if (is_ripemd) w_touch(tx, to);
    }
  }
  finish_child(f, r, out_off, out_size);
  f.pc += 1;
}

static void op_create_family(Frame& f, bool is_create2) {
  TxCtx& tx = f.tx;
  if (f.is_static) throw VmError(E_STATIC);
  U256 value = f.pop();
  U256 off_w = f.pop(), size_w = f.pop();
  U256 salt = is_create2 ? f.pop() : U256{};

  unsigned __int128 cost = f.fee(F_create) + f.mem_gas(off_w, size_w);
  if (is_create2) {
    unsigned __int128 words =
        ((unsigned __int128)sat_u64(size_w) + 31) / 32;
    cost += (unsigned __int128)f.fee(F_sha3word) * words;
  }
  f.charge(cost);
  uint64_t off = sat_u64(off_w), size = sat_u64(size_w);
  std::vector<uint8_t> init_code;
  f.mem.load(off, size, init_code);

  bool byz = tx.flag(C_byzantium);
  if (f.depth + 1 > 1024 || ucmp(r_balance(tx, f.owner), value) < 0) {
    f.push(U256{});
    if (byz) f.returndata.clear();
    f.pc += 1;
    return;
  }

  int64_t child_gas = consume_child_gas(f, from_u64((uint64_t)f.gas));
  uint64_t nonce = r_nonce(tx, f.owner);
  w_inc_nonce(tx, f.owner);
  Addr new_addr;
  if (is_create2)
    create2_address(f.owner, salt, init_code.data(), init_code.size(),
                    new_addr);
  else
    create_address(f.owner, nonce, new_addr);

  RunResult r = create_contract(tx, f.owner, f.origin, new_addr, child_gas,
                                f.gas_price, value, init_code.data(),
                                init_code.size(), f.depth + 1);
  if (r.status == OK) {
    f.gas += r.gas_remaining;
    f.refund += r.refund;
    f.push(addr_to_word(new_addr));
    if (byz) f.returndata.clear();
  } else if (r.status == REVERT) {
    f.gas += r.gas_remaining;
    f.push(U256{});
    if (byz) f.returndata = r.output;
  } else {
    f.push(U256{});
    if (byz) f.returndata.clear();
  }
  f.pc += 1;
}

static void op_selfdestruct(Frame& f) {
  TxCtx& tx = f.tx;
  if (f.is_static) throw VmError(E_STATIC);
  Addr ben = to_addr(f.pop());
  unsigned __int128 cost = f.fee(F_selfdestruct);
  if (tx.flag(C_eip150)) {
    if (tx.flag(C_eip161)) {
      if (!is_zero(r_balance(tx, f.owner)) && r_dead(tx, ben))
        cost += f.fee(F_newaccount);
    } else if (!r_exists(tx, ben)) {
      cost += f.fee(F_newaccount);
    }
  }
  f.charge(cost);
  if (!tx.frame.selfdestructed.count(f.owner)) {
    f.refund += (int64_t)f.fee(F_r_selfdestruct);
    w_sd_mark(tx, f.owner);
  }
  U256 bal = r_balance(tx, f.owner);
  if (!tx.flag(C_eip161)) w_init_if_missing(tx, ben);
  w_add_balance(tx, ben, bal, false);
  // re-read handles beneficiary == owner (funds destroyed)
  w_add_balance(tx, f.owner, r_balance(tx, f.owner), true);
  w_touch(tx, ben);
  f.halted = true;
}

static void op_sstore(Frame& f) {
  TxCtx& tx = f.tx;
  if (f.is_static) throw VmError(E_STATIC);
  U256 key = f.pop(), value = f.pop();
  const Addr& owner = f.owner;
  if (tx.flag(C_istanbul)) {
    // EIP-2200 net metering (vm.py _op_sstore Istanbul branch)
    if ((uint64_t)f.gas <= f.fee(F_sstore_sentry)) throw VmError(E_OOG);
    U256 current = r_storage(tx, owner, key);
    if (eq(value, current)) {
      f.charge(f.fee(F_sstore_noop));
      f.pc += 1;
      return;
    }
    U256 original = r_original(tx, owner, key);
    if (eq(original, current)) {
      if (is_zero(original)) {
        f.charge(f.fee(F_sstore_init));
      } else {
        f.charge(f.fee(F_sstore_clean));
        if (is_zero(value)) f.refund += (int64_t)f.fee(F_r_sclear);
      }
    } else {
      f.charge(f.fee(F_sstore_noop));
      if (!is_zero(original)) {
        if (is_zero(current)) f.refund -= (int64_t)f.fee(F_r_sclear);
        if (is_zero(value)) f.refund += (int64_t)f.fee(F_r_sclear);
      }
      if (eq(original, value)) {
        if (is_zero(original))
          f.refund += (int64_t)(f.fee(F_sstore_init) - f.fee(F_sstore_noop));
        else
          f.refund += (int64_t)(f.fee(F_sstore_clean) - f.fee(F_sstore_noop));
      }
    }
    w_save_storage(tx, owner, key, value);
    f.pc += 1;
    return;
  }
  // Frontier..Petersburg metering
  U256 current = r_storage(tx, owner, key);
  if (is_zero(current) && !is_zero(value)) {
    f.charge(f.fee(F_sset));
  } else {
    f.charge(f.fee(F_sreset));
    if (!is_zero(current) && is_zero(value))
      f.refund += (int64_t)f.fee(F_r_sclear);
  }
  w_save_storage(tx, owner, key, value);
  f.pc += 1;
}

// the fetch-decode-execute loop (vm.py run / VM.scala:14-60)
static RunResult run_frame(TxCtx& tx, const MsgEnv& env, const uint8_t* code,
                           uint64_t code_len, int64_t gas) {
  Frame f(tx);
  f.owner = env.owner;
  f.caller = env.caller;
  f.origin = env.origin;
  f.gas_price = env.gas_price;
  f.value = env.value;
  f.input = env.input;
  f.input_len = env.input_len;
  f.depth = env.depth;
  f.is_static = env.is_static;
  f.code = code;
  f.code_len = code_len;
  f.gas = gas;
  f.analyze_jumpdests();

  RunResult out;
  try {
    while (!f.halted) {
      uint8_t op = f.pc < code_len ? code[f.pc] : 0x00;
      switch (op) {
        case 0x00:  // STOP
          f.charge(f.fee(F_zero));
          f.halted = true;
          break;
        case 0x01: {  // ADD
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          f.push(add(a, b));
          f.pc += 1;
          break;
        }
        case 0x02: {  // MUL
          f.charge(f.fee(F_low));
          U256 a = f.pop(), b = f.pop();
          f.push(mul(a, b));
          f.pc += 1;
          break;
        }
        case 0x03: {  // SUB
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          f.push(sub(a, b));
          f.pc += 1;
          break;
        }
        case 0x04: {  // DIV
          f.charge(f.fee(F_low));
          U256 a = f.pop(), b = f.pop(), q, r;
          udivmod(a, b, q, r);
          f.push(is_zero(b) ? U256{} : q);
          f.pc += 1;
          break;
        }
        case 0x05: {  // SDIV
          f.charge(f.fee(F_low));
          U256 a = f.pop(), b = f.pop();
          f.push(sdiv(a, b));
          f.pc += 1;
          break;
        }
        case 0x06: {  // MOD
          f.charge(f.fee(F_low));
          U256 a = f.pop(), b = f.pop(), q, r;
          udivmod(a, b, q, r);
          f.push(is_zero(b) ? U256{} : r);
          f.pc += 1;
          break;
        }
        case 0x07: {  // SMOD
          f.charge(f.fee(F_low));
          U256 a = f.pop(), b = f.pop();
          f.push(smod(a, b));
          f.pc += 1;
          break;
        }
        case 0x08: {  // ADDMOD
          f.charge(f.fee(F_mid));
          U256 a = f.pop(), b = f.pop(), n = f.pop();
          if (is_zero(n)) {
            f.push(U256{});
          } else {
            uint64_t wide[8] = {0};
            // a + b can be 257 bits: do it in the 512-bit buffer
            unsigned __int128 c = 0;
            for (int i = 0; i < 4; ++i) {
              c += (unsigned __int128)a.w[i] + b.w[i];
              wide[i] = (uint64_t)c;
              c >>= 64;
            }
            wide[4] = (uint64_t)c;
            f.push(mod512(wide, n));
          }
          f.pc += 1;
          break;
        }
        case 0x09: {  // MULMOD
          f.charge(f.fee(F_mid));
          U256 a = f.pop(), b = f.pop(), n = f.pop();
          if (is_zero(n)) {
            f.push(U256{});
          } else {
            uint64_t wide[8];
            mul_full(a, b, wide);
            f.push(mod512(wide, n));
          }
          f.pc += 1;
          break;
        }
        case 0x0A: {  // EXP
          U256 a = f.pop(), e = f.pop();
          uint64_t nbytes = (bit_length(e) + 7) / 8;
          f.charge((unsigned __int128)f.fee(F_exp) +
                   (unsigned __int128)f.fee(F_expbyte) * nbytes);
          f.push(uexp(a, e));
          f.pc += 1;
          break;
        }
        case 0x0B: {  // SIGNEXTEND
          f.charge(f.fee(F_low));
          U256 a = f.pop(), b = f.pop();
          f.push(signextend(a, b));
          f.pc += 1;
          break;
        }
        case 0x10: {  // LT
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          f.push(from_u64(ucmp(a, b) < 0 ? 1 : 0));
          f.pc += 1;
          break;
        }
        case 0x11: {  // GT
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          f.push(from_u64(ucmp(a, b) > 0 ? 1 : 0));
          f.pc += 1;
          break;
        }
        case 0x12: {  // SLT
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          bool na = sign_bit(a), nb = sign_bit(b);
          bool lt = (na != nb) ? na : (ucmp(a, b) < 0);
          f.push(from_u64(lt ? 1 : 0));
          f.pc += 1;
          break;
        }
        case 0x13: {  // SGT
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          bool na = sign_bit(a), nb = sign_bit(b);
          bool gt = (na != nb) ? nb : (ucmp(a, b) > 0);
          f.push(from_u64(gt ? 1 : 0));
          f.pc += 1;
          break;
        }
        case 0x14: {  // EQ
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop();
          f.push(from_u64(eq(a, b) ? 1 : 0));
          f.pc += 1;
          break;
        }
        case 0x15: {  // ISZERO
          f.charge(f.fee(F_verylow));
          f.push(from_u64(is_zero(f.pop()) ? 1 : 0));
          f.pc += 1;
          break;
        }
        case 0x16: {  // AND
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop(), r;
          for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] & b.w[i];
          f.push(r);
          f.pc += 1;
          break;
        }
        case 0x17: {  // OR
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop(), r;
          for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] | b.w[i];
          f.push(r);
          f.pc += 1;
          break;
        }
        case 0x18: {  // XOR
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), b = f.pop(), r;
          for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] ^ b.w[i];
          f.push(r);
          f.pc += 1;
          break;
        }
        case 0x19: {  // NOT
          f.charge(f.fee(F_verylow));
          U256 a = f.pop(), r;
          for (int i = 0; i < 4; ++i) r.w[i] = ~a.w[i];
          f.push(r);
          f.pc += 1;
          break;
        }
        case 0x1A: {  // BYTE
          f.charge(f.fee(F_verylow));
          U256 i = f.pop(), x = f.pop();
          f.push(byte_at(i, x));
          f.pc += 1;
          break;
        }
        case 0x1B: {  // SHL (EIP-145)
          if (!tx.flag(C_constantinople)) throw VmError(E_INVALID_OP);
          f.charge(f.fee(F_verylow));
          U256 s = f.pop(), x = f.pop();
          f.push((s.w[1] | s.w[2] | s.w[3] || s.w[0] >= 256)
                     ? U256{}
                     : shl(x, (unsigned)s.w[0]));
          f.pc += 1;
          break;
        }
        case 0x1C: {  // SHR
          if (!tx.flag(C_constantinople)) throw VmError(E_INVALID_OP);
          f.charge(f.fee(F_verylow));
          U256 s = f.pop(), x = f.pop();
          f.push((s.w[1] | s.w[2] | s.w[3] || s.w[0] >= 256)
                     ? U256{}
                     : shr(x, (unsigned)s.w[0]));
          f.pc += 1;
          break;
        }
        case 0x1D: {  // SAR
          if (!tx.flag(C_constantinople)) throw VmError(E_INVALID_OP);
          f.charge(f.fee(F_verylow));
          U256 s = f.pop(), x = f.pop();
          unsigned sh = (s.w[1] | s.w[2] | s.w[3] || s.w[0] >= 256)
                            ? 256
                            : (unsigned)s.w[0];
          f.push(sar(x, sh));
          f.pc += 1;
          break;
        }
        case 0x20: {  // SHA3
          U256 off_w = f.pop(), size_w = f.pop();
          unsigned __int128 words =
              ((unsigned __int128)sat_u64(size_w) + 31) / 32;
          f.charge((unsigned __int128)f.fee(F_sha3) +
                   (unsigned __int128)f.fee(F_sha3word) * words +
                   f.mem_gas(off_w, size_w));
          uint64_t off = sat_u64(off_w), size = sat_u64(size_w);
          f.mem.expand(off, size);
          uint8_t h[32];
          khipu_keccak(136, size ? f.mem.data.data() + off : nullptr, size, h,
                       32);
          f.push(from_be(h, 32));
          f.pc += 1;
          break;
        }
        case 0x30:  // ADDRESS
          f.charge(f.fee(F_base));
          f.push(addr_to_word(f.owner));
          f.pc += 1;
          break;
        case 0x31: {  // BALANCE
          Addr a = to_addr(f.pop());
          f.charge(f.fee(F_balance));
          f.push(r_balance(tx, a));
          f.pc += 1;
          break;
        }
        case 0x32:  // ORIGIN
          f.charge(f.fee(F_base));
          f.push(addr_to_word(f.origin));
          f.pc += 1;
          break;
        case 0x33:  // CALLER
          f.charge(f.fee(F_base));
          f.push(addr_to_word(f.caller));
          f.pc += 1;
          break;
        case 0x34:  // CALLVALUE
          f.charge(f.fee(F_base));
          f.push(f.value);
          f.pc += 1;
          break;
        case 0x35: {  // CALLDATALOAD
          U256 off_w = f.pop();
          f.charge(f.fee(F_verylow));
          uint64_t off = sat_u64(off_w);
          if (off >= f.input_len) {
            f.push(U256{});
          } else {
            uint8_t buf[32] = {0};
            uint64_t n = f.input_len - off;
            if (n > 32) n = 32;
            std::memcpy(buf, f.input + off, n);
            f.push(from_be(buf, 32));
          }
          f.pc += 1;
          break;
        }
        case 0x36:  // CALLDATASIZE
          f.charge(f.fee(F_base));
          f.push(from_u64(f.input_len));
          f.pc += 1;
          break;
        case 0x37: {  // CALLDATACOPY
          U256 dst_w = f.pop(), src_w = f.pop(), size_w = f.pop();
          unsigned __int128 words =
              ((unsigned __int128)sat_u64(size_w) + 31) / 32;
          f.charge((unsigned __int128)f.fee(F_verylow) +
                   (unsigned __int128)f.fee(F_copy) * words +
                   f.mem_gas(dst_w, size_w));
          uint64_t dst = sat_u64(dst_w), src = sat_u64(src_w),
                   size = sat_u64(size_w);
          f.mem.expand(dst, size);
          // avail guards src+i wraparound at src near 2^64 (zero-pad
          // region, matching vm.py _zero_slice)
          uint64_t avail = src < f.input_len ? f.input_len - src : 0;
          for (uint64_t i = 0; i < size; ++i)
            f.mem.data[dst + i] = (i < avail) ? f.input[src + i] : 0;
          f.pc += 1;
          break;
        }
        case 0x38:  // CODESIZE
          f.charge(f.fee(F_base));
          f.push(from_u64(f.code_len));
          f.pc += 1;
          break;
        case 0x39: {  // CODECOPY
          U256 dst_w = f.pop(), src_w = f.pop(), size_w = f.pop();
          unsigned __int128 words =
              ((unsigned __int128)sat_u64(size_w) + 31) / 32;
          f.charge((unsigned __int128)f.fee(F_verylow) +
                   (unsigned __int128)f.fee(F_copy) * words +
                   f.mem_gas(dst_w, size_w));
          uint64_t dst = sat_u64(dst_w), src = sat_u64(src_w),
                   size = sat_u64(size_w);
          f.mem.expand(dst, size);
          uint64_t avail = src < f.code_len ? f.code_len - src : 0;
          for (uint64_t i = 0; i < size; ++i)
            f.mem.data[dst + i] = (i < avail) ? f.code[src + i] : 0;
          f.pc += 1;
          break;
        }
        case 0x3A:  // GASPRICE
          f.charge(f.fee(F_base));
          f.push(f.gas_price);
          f.pc += 1;
          break;
        case 0x3B: {  // EXTCODESIZE
          Addr a = to_addr(f.pop());
          f.charge(f.fee(F_extcode));
          const uint8_t* p = nullptr;
          uint64_t n = 0;
          r_code(tx, a, &p, &n);
          f.push(from_u64(n));
          f.pc += 1;
          break;
        }
        case 0x3C: {  // EXTCODECOPY
          Addr a = to_addr(f.pop());
          U256 dst_w = f.pop(), src_w = f.pop(), size_w = f.pop();
          unsigned __int128 words =
              ((unsigned __int128)sat_u64(size_w) + 31) / 32;
          f.charge((unsigned __int128)f.fee(F_extcode) +
                   (unsigned __int128)f.fee(F_copy) * words +
                   f.mem_gas(dst_w, size_w));
          uint64_t dst = sat_u64(dst_w), src = sat_u64(src_w),
                   size = sat_u64(size_w);
          f.mem.expand(dst, size);
          const uint8_t* p = nullptr;
          uint64_t n = 0;
          r_code(tx, a, &p, &n);
          uint64_t avail = src < n ? n - src : 0;
          for (uint64_t i = 0; i < size; ++i)
            f.mem.data[dst + i] = (i < avail) ? p[src + i] : 0;
          f.pc += 1;
          break;
        }
        case 0x3D:  // RETURNDATASIZE
          if (!tx.flag(C_byzantium)) throw VmError(E_INVALID_OP);
          f.charge(f.fee(F_base));
          f.push(from_u64(f.returndata.size()));
          f.pc += 1;
          break;
        case 0x3E: {  // RETURNDATACOPY
          if (!tx.flag(C_byzantium)) throw VmError(E_INVALID_OP);
          U256 dst_w = f.pop(), src_w = f.pop(), size_w = f.pop();
          unsigned __int128 words =
              ((unsigned __int128)sat_u64(size_w) + 31) / 32;
          f.charge((unsigned __int128)f.fee(F_verylow) +
                   (unsigned __int128)f.fee(F_copy) * words +
                   f.mem_gas(dst_w, size_w));
          uint64_t dst = sat_u64(dst_w), src = sat_u64(src_w),
                   size = sat_u64(size_w);
          if ((unsigned __int128)src + size > f.returndata.size())
            throw VmError(E_RETURNDATA);
          f.mem.store(dst, f.returndata.data() + src, size);
          f.pc += 1;
          break;
        }
        case 0x3F: {  // EXTCODEHASH
          if (!tx.flag(C_constantinople)) throw VmError(E_INVALID_OP);
          Addr a = to_addr(f.pop());
          f.charge(f.fee(F_extcodehash));
          if (r_dead(tx, a)) {
            f.push(U256{});
          } else {
            uint8_t h[32];
            r_code_hash(tx, a, h);
            f.push(from_be(h, 32));
          }
          f.pc += 1;
          break;
        }
        case 0x40: {  // BLOCKHASH
          U256 n_w = f.pop();
          f.charge(f.fee(F_blockhash));
          uint64_t cur = tx.blk.number;
          uint64_t n = sat_u64(n_w);
          bool in_range = !(n_w.w[1] | n_w.w[2] | n_w.w[3]) &&
                          cur >= 1 && n < cur &&
                          n + 256 >= cur;
          if (in_range) {
            uint8_t h[32];
            if (tx.cb.blockhash(tx.cb.h, n, h))
              f.push(from_be(h, 32));
            else
              f.push(U256{});
          } else {
            f.push(U256{});
          }
          f.pc += 1;
          break;
        }
        case 0x41:  // COINBASE
          f.charge(f.fee(F_base));
          f.push(addr_to_word(tx.blk.beneficiary));
          f.pc += 1;
          break;
        case 0x42:  // TIMESTAMP
          f.charge(f.fee(F_base));
          f.push(from_u64(tx.blk.timestamp));
          f.pc += 1;
          break;
        case 0x43:  // NUMBER
          f.charge(f.fee(F_base));
          f.push(from_u64(tx.blk.number));
          f.pc += 1;
          break;
        case 0x44:  // DIFFICULTY
          f.charge(f.fee(F_base));
          f.push(tx.blk.difficulty);
          f.pc += 1;
          break;
        case 0x45:  // GASLIMIT
          f.charge(f.fee(F_base));
          f.push(from_u64(tx.blk.gas_limit));
          f.pc += 1;
          break;
        case 0x46:  // CHAINID (Istanbul)
          if (!tx.flag(C_istanbul)) throw VmError(E_INVALID_OP);
          f.charge(f.fee(F_base));
          f.push(from_u64(tx.cfg[C_chain_id]));
          f.pc += 1;
          break;
        case 0x47:  // SELFBALANCE (Istanbul)
          if (!tx.flag(C_istanbul)) throw VmError(E_INVALID_OP);
          f.charge(f.fee(F_low));
          f.push(r_balance(tx, f.owner));
          f.pc += 1;
          break;
        case 0x50:  // POP
          f.charge(f.fee(F_base));
          f.pop();
          f.pc += 1;
          break;
        case 0x51: {  // MLOAD
          U256 off_w = f.pop();
          f.charge((unsigned __int128)f.fee(F_verylow) +
                   f.mem_gas(off_w, from_u64(32)));
          uint64_t off = sat_u64(off_w);
          f.mem.expand(off, 32);
          f.push(from_be(f.mem.data.data() + off, 32));
          f.pc += 1;
          break;
        }
        case 0x52: {  // MSTORE
          U256 off_w = f.pop(), val = f.pop();
          f.charge((unsigned __int128)f.fee(F_verylow) +
                   f.mem_gas(off_w, from_u64(32)));
          uint64_t off = sat_u64(off_w);
          f.mem.expand(off, 32);
          to_be32(val, f.mem.data.data() + off);
          f.pc += 1;
          break;
        }
        case 0x53: {  // MSTORE8
          U256 off_w = f.pop(), val = f.pop();
          f.charge((unsigned __int128)f.fee(F_verylow) +
                   f.mem_gas(off_w, from_u64(1)));
          uint64_t off = sat_u64(off_w);
          f.mem.expand(off, 1);
          f.mem.data[off] = (uint8_t)(val.w[0] & 0xFF);
          f.pc += 1;
          break;
        }
        case 0x54: {  // SLOAD
          U256 key = f.pop();
          f.charge(f.fee(F_sload));
          f.push(r_storage(tx, f.owner, key));
          f.pc += 1;
          break;
        }
        case 0x55:  // SSTORE
          op_sstore(f);
          break;
        case 0x56: {  // JUMP
          U256 dest_w = f.pop();
          f.charge(f.fee(F_mid));
          uint64_t dest = sat_u64(dest_w);
          if ((dest_w.w[1] | dest_w.w[2] | dest_w.w[3]) ||
              !f.valid_jumpdest(dest))
            throw VmError(E_INVALID_JUMP);
          f.pc = dest;
          break;
        }
        case 0x57: {  // JUMPI
          U256 dest_w = f.pop(), cond = f.pop();
          f.charge(f.fee(F_high));
          if (!is_zero(cond)) {
            uint64_t dest = sat_u64(dest_w);
            if ((dest_w.w[1] | dest_w.w[2] | dest_w.w[3]) ||
                !f.valid_jumpdest(dest))
              throw VmError(E_INVALID_JUMP);
            f.pc = dest;
          } else {
            f.pc += 1;
          }
          break;
        }
        case 0x58:  // PC
          f.charge(f.fee(F_base));
          f.push(from_u64(f.pc));
          f.pc += 1;
          break;
        case 0x59:  // MSIZE
          f.charge(f.fee(F_base));
          f.push(from_u64(f.mem.active_words * 32));
          f.pc += 1;
          break;
        case 0x5A:  // GAS
          f.charge(f.fee(F_base));
          f.push(from_u64((uint64_t)f.gas));
          f.pc += 1;
          break;
        case 0x5B:  // JUMPDEST
          f.charge(f.fee(F_jumpdest));
          f.pc += 1;
          break;
        case 0xF0:  // CREATE
          op_create_family(f, false);
          break;
        case 0xF1:  // CALL
          op_call_family(f, K_CALL);
          break;
        case 0xF2:  // CALLCODE
          op_call_family(f, K_CALLCODE);
          break;
        case 0xF3: {  // RETURN
          U256 off_w = f.pop(), size_w = f.pop();
          f.charge((unsigned __int128)f.fee(F_zero) +
                   f.mem_gas(off_w, size_w));
          uint64_t off = sat_u64(off_w), size = sat_u64(size_w);
          f.mem.load(off, size, f.output);
          f.halted = true;
          f.pc += 1;
          break;
        }
        case 0xF4:  // DELEGATECALL (Homestead)
          if (!tx.flag(C_homestead)) throw VmError(E_INVALID_OP);
          op_call_family(f, K_DELEGATE);
          break;
        case 0xF5:  // CREATE2 (Constantinople)
          if (!tx.flag(C_constantinople)) throw VmError(E_INVALID_OP);
          op_create_family(f, true);
          break;
        case 0xFA:  // STATICCALL (Byzantium)
          if (!tx.flag(C_byzantium)) throw VmError(E_INVALID_OP);
          op_call_family(f, K_STATIC);
          break;
        case 0xFD: {  // REVERT (Byzantium)
          if (!tx.flag(C_byzantium)) throw VmError(E_INVALID_OP);
          U256 off_w = f.pop(), size_w = f.pop();
          f.charge((unsigned __int128)f.fee(F_zero) +
                   f.mem_gas(off_w, size_w));
          uint64_t off = sat_u64(off_w), size = sat_u64(size_w);
          f.mem.load(off, size, f.output);
          f.halted = true;
          f.reverted = true;
          f.pc += 1;
          break;
        }
        case 0xFE:  // INVALID
          throw VmError(E_INVALID_OP);
        case 0xFF:  // SELFDESTRUCT
          op_selfdestruct(f);
          break;
        default: {
          if (op >= 0x60 && op <= 0x7F) {  // PUSH1..PUSH32
            f.charge(f.fee(F_verylow));
            unsigned n = op - 0x60 + 1;
            uint8_t buf[32] = {0};
            for (unsigned i = 0; i < n; ++i) {
              uint64_t p = f.pc + 1 + i;
              buf[32 - n + i] = p < code_len ? code[p] : 0;
            }
            f.push(from_be(buf, 32));
            f.pc += 1 + n;
          } else if (op >= 0x80 && op <= 0x8F) {  // DUP1..DUP16
            f.charge(f.fee(F_verylow));
            unsigned i = op - 0x80 + 1;
            if (f.stack.size() < i) throw VmError(E_STACK_UNDER);
            if (f.stack.size() >= 1024) throw VmError(E_STACK_OVER);
            f.stack.push_back(f.stack[f.stack.size() - i]);
            f.pc += 1;
          } else if (op >= 0x90 && op <= 0x9F) {  // SWAP1..SWAP16
            f.charge(f.fee(F_verylow));
            unsigned i = op - 0x90 + 1;
            if (f.stack.size() < i + 1) throw VmError(E_STACK_UNDER);
            std::swap(f.stack[f.stack.size() - 1],
                      f.stack[f.stack.size() - 1 - i]);
            f.pc += 1;
          } else if (op >= 0xA0 && op <= 0xA4) {  // LOG0..LOG4
            if (f.is_static) throw VmError(E_STATIC);
            int ntopics = op - 0xA0;
            U256 off_w = f.pop(), size_w = f.pop();
            U256 topics[4];
            for (int i = 0; i < ntopics; ++i) topics[i] = f.pop();
            f.charge((unsigned __int128)f.fee(F_log) +
                     (unsigned __int128)f.fee(F_logtopic) * ntopics +
                     (unsigned __int128)f.fee(F_logdata) * sat_u64(size_w) +
                     f.mem_gas(off_w, size_w));
            uint64_t off = sat_u64(off_w), size = sat_u64(size_w);
            f.mem.expand(off, size);
            w_log(tx, f.owner, topics, ntopics,
                  size ? f.mem.data.data() + off : nullptr, size);
            f.pc += 1;
          } else {
            throw VmError(E_INVALID_OP);
          }
          break;
        }
      }
    }
  } catch (const VmError& e) {
    out.status = e.code;
    out.gas_remaining = 0;
    return out;
  }
  out.status = f.reverted ? REVERT : OK;
  out.gas_remaining = f.gas;
  out.refund = f.refund;
  out.output = std::move(f.output);
  return out;
}

// precompile-or-bytecode dispatch (vm.py _execute_message)
static RunResult execute_message(TxCtx& tx, const MsgEnv& env,
                                 const uint8_t* code, uint64_t code_len,
                                 int64_t gas, const Addr& code_addr) {
  uint32_t pid = precompile_id(tx, code_addr);
  if (pid != 0) {
    const uint8_t* out = nullptr;
    uint64_t outlen = 0, gas_left = 0;
    int status = tx.cb.precompile(tx.cb.h, pid, env.input, env.input_len,
                                  (uint64_t)gas, &out, &outlen, &gas_left);
    RunResult r;
    if (status == 0) {
      r.status = OK;
      r.gas_remaining = (int64_t)gas_left;
      r.output.assign(out, out + outlen);
    } else if (status == 1) {
      r.status = E_PRECOMPILE_OOG;
    } else {
      r.status = E_PRECOMPILE;
    }
    return r;
  }
  if (code_len == 0) {
    RunResult r;
    r.status = OK;
    r.gas_remaining = gas;
    return r;
  }
  return run_frame(tx, env, code, code_len, gas);
}

// shared CREATE/CREATE2/tx-creation body (vm.py create_contract)
static RunResult create_contract(TxCtx& tx, const Addr& caller,
                                 const Addr& origin, const Addr& new_addr,
                                 int64_t gas, const U256& gas_price,
                                 const U256& value, const uint8_t* init_code,
                                 uint64_t init_len, uint32_t depth) {
  FrameState saved = tx.frame;
  size_t oplog_mark = tx.oplog.size();

  // EIP-684 collision: existing nonce or code at the target
  const BaseAcct* base = nullptr;
  bool exists;
  uint64_t cur_nonce = 0;
  bool code_hash_empty = true;
  {
    auto it = tx.frame.accts.find(new_addr);
    if (it != tx.frame.accts.end() && it->second.has_abs) {
      exists = true;
      cur_nonce = it->second.abs_nonce + it->second.nonce_delta;
      const auto* c = overlay_code(tx, new_addr);
      code_hash_empty = !c || c->empty();
    } else if (it != tx.frame.accts.end() && it->second.any_delta() &&
               !sign_bit(it->second.bal_delta)) {
      // delta-materialized account: nonce delta only, no code
      base = &base_account(tx, new_addr);
      exists = true;
      cur_nonce = (base->exists ? base->nonce : tx.cfg[C_start_nonce]) +
                  it->second.nonce_delta;
      code_hash_empty = std::memcmp(base->exists ? base->code_hash.data()
                                                 : EMPTY_HASH,
                                    EMPTY_HASH, 32) == 0;
    } else {
      base = &base_account(tx, new_addr);  // records ON_ACCOUNT read
      exists = base->exists;
      cur_nonce = base->nonce;
      code_hash_empty =
          std::memcmp(base->code_hash.data(), EMPTY_HASH, 32) == 0;
      if (it != tx.frame.accts.end())
        cur_nonce += it->second.nonce_delta;
    }
  }
  if (exists &&
      (cur_nonce != tx.cfg[C_start_nonce] || !code_hash_empty)) {
    RunResult r;
    r.status = E_COLLISION;
    return r;
  }

  U256 prior_balance = r_balance(tx, new_addr);
  w_create_account(tx, new_addr, tx.cfg[C_contract_start_nonce],
                   prior_balance);
  w_transfer(tx, caller, new_addr, value);

  MsgEnv env;
  env.owner = new_addr;
  env.caller = caller;
  env.origin = origin;
  env.gas_price = gas_price;
  env.value = value;
  env.input = nullptr;
  env.input_len = 0;
  env.depth = depth;
  env.is_static = false;

  RunResult r = run_frame(tx, env, init_code, init_len, gas);
  if (r.status != OK) {
    tx.frame = std::move(saved);
    tx.oplog.resize(oplog_mark);
    return r;
  }
  uint64_t code_size = r.output.size();
  if (tx.flag(C_eip170) && code_size > tx.cfg[C_max_code_size]) {
    tx.frame = std::move(saved);
    tx.oplog.resize(oplog_mark);
    RunResult e;
    e.status = E_CODE_SIZE;
    return e;
  }
  int64_t deposit = (int64_t)(code_size * tx.fee(F_codedeposit));
  if (r.gas_remaining >= deposit) {
    r.gas_remaining -= deposit;
    w_save_code(tx, new_addr, r.output.data(), code_size);
  } else if (tx.flag(C_homestead)) {  // fail_on_create_deposit_oog
    tx.frame = std::move(saved);
    tx.oplog.resize(oplog_mark);
    RunResult e;
    e.status = E_DEPOSIT_OOG;
    return e;
  } else {
    w_save_code(tx, new_addr, nullptr, 0);  // Frontier: keep empty
  }
  return r;
}

}  // namespace evm

// ================================================================ C API

extern "C" {

struct EvmResultC {
  int32_t status;  // evm::Err
  int32_t _pad;
  uint64_t gas_remaining;
  int64_t refund;
  const uint8_t* output;
  uint64_t output_len;
  const uint8_t* oplog;
  uint64_t oplog_len;
  void* owner_;
};

struct ResultHolder {
  EvmResultC pub;
  std::vector<uint8_t> output;
  std::vector<uint8_t> oplog;
};

static EvmResultC* finish(evm::TxCtx& tx, evm::RunResult& r) {
  auto* h = new ResultHolder();
  h->output = std::move(r.output);
  h->oplog = std::move(tx.oplog);
  h->pub.status = r.status;
  h->pub.gas_remaining = (uint64_t)(r.gas_remaining > 0 ? r.gas_remaining : 0);
  h->pub.refund = r.refund;
  h->pub.output = h->output.data();
  h->pub.output_len = h->output.size();
  h->pub.oplog = h->oplog.data();
  h->pub.oplog_len = h->oplog.size();
  h->pub.owner_ = h;
  return &h->pub;
}

static void unpack(evm::TxCtx& tx, const uint64_t* cfg, void** cbs,
                   void* handle, const uint64_t* blk_nums,
                   const uint8_t* blk_bytes) {
  tx.cfg = cfg;
  tx.cb.h = handle;
  tx.cb.exists = (evm::cb_exists_t)cbs[0];
  tx.cb.is_dead = (evm::cb_is_dead_t)cbs[1];
  tx.cb.get_account = (evm::cb_get_account_t)cbs[2];
  tx.cb.get_code_hash = (evm::cb_get_code_hash_t)cbs[3];
  tx.cb.get_code = (evm::cb_get_code_t)cbs[4];
  tx.cb.get_storage = (evm::cb_get_storage_t)cbs[5];
  tx.cb.get_original = (evm::cb_get_storage_t)cbs[6];
  tx.cb.blockhash = (evm::cb_blockhash_t)cbs[7];
  tx.cb.precompile = (evm::cb_precompile_t)cbs[8];
  tx.blk.number = blk_nums[0];
  tx.blk.timestamp = blk_nums[1];
  tx.blk.gas_limit = blk_nums[2];
  tx.blk.difficulty = evm::from_be(blk_bytes, 32);
  std::memcpy(tx.blk.beneficiary.data(), blk_bytes + 32, 20);
}

EvmResultC* khipu_evm_call(const uint64_t* cfg, void** cbs, void* handle,
                           const uint64_t* blk_nums, const uint8_t* blk_bytes,
                           const uint8_t* owner, const uint8_t* caller,
                           const uint8_t* origin, const uint8_t* gas_price32,
                           const uint8_t* value32, const uint8_t* input,
                           uint64_t input_len, uint32_t depth,
                           uint32_t is_static, const uint8_t* code,
                           uint64_t code_len, const uint8_t* code_addr,
                           uint64_t gas, uint32_t pre_transfer) {
  evm::TxCtx tx;
  unpack(tx, cfg, cbs, handle, blk_nums, blk_bytes);
  evm::MsgEnv env;
  std::memcpy(env.owner.data(), owner, 20);
  std::memcpy(env.caller.data(), caller, 20);
  std::memcpy(env.origin.data(), origin, 20);
  env.gas_price = evm::from_be(gas_price32, 32);
  env.value = evm::from_be(value32, 32);
  env.input = input;
  env.input_len = input_len;
  env.depth = depth;
  env.is_static = is_static != 0;
  evm::Addr caddr;
  std::memcpy(caddr.data(), code_addr, 20);
  if (pre_transfer) {
    // the tx-level value transfer execute_transaction applies to the
    // child world before _execute_message (ledger.py:179-181); emitting
    // it here makes it roll back with the frame on error/revert
    evm::w_transfer(tx, env.caller, env.owner, env.value);
    evm::w_touch(tx, env.owner);
  }
  evm::RunResult r =
      evm::execute_message(tx, env, code, code_len, (int64_t)gas, caddr);
  if (r.status != evm::OK) tx.oplog.clear();
  return finish(tx, r);
}

EvmResultC* khipu_evm_create(const uint64_t* cfg, void** cbs, void* handle,
                             const uint64_t* blk_nums,
                             const uint8_t* blk_bytes, const uint8_t* caller,
                             const uint8_t* origin, const uint8_t* new_addr,
                             const uint8_t* gas_price32,
                             const uint8_t* value32, const uint8_t* init_code,
                             uint64_t code_len, uint32_t depth, uint64_t gas) {
  evm::TxCtx tx;
  unpack(tx, cfg, cbs, handle, blk_nums, blk_bytes);
  evm::Addr c, o, na;
  std::memcpy(c.data(), caller, 20);
  std::memcpy(o.data(), origin, 20);
  std::memcpy(na.data(), new_addr, 20);
  evm::RunResult r = evm::create_contract(
      tx, c, o, na, (int64_t)gas, evm::from_be(gas_price32, 32),
      evm::from_be(value32, 32), init_code, code_len, depth);
  if (r.status != evm::OK) tx.oplog.clear();
  return finish(tx, r);
}

void khipu_evm_free(EvmResultC* r) {
  if (r) delete (ResultHolder*)r->owner_;
}

// test hook: raw u256 arithmetic, differential-tested from Python
// op: 0 add 1 sub 2 mul 3 div 4 mod 5 sdiv 6 smod 7 exp 8 addmod
//     9 mulmod 10 signextend 11 byte 12 shl 13 shr 14 sar
void khipu_evm_test_arith(int op, const uint8_t* a32, const uint8_t* b32,
                          const uint8_t* c32, uint8_t* out32) {
  using namespace evm;
  U256 a = from_be(a32, 32), b = from_be(b32, 32), c = from_be(c32, 32);
  U256 r, q, rem;
  switch (op) {
    case 0: r = add(a, b); break;
    case 1: r = sub(a, b); break;
    case 2: r = mul(a, b); break;
    case 3: udivmod(a, b, q, rem); r = is_zero(b) ? U256{} : q; break;
    case 4: udivmod(a, b, q, rem); r = is_zero(b) ? U256{} : rem; break;
    case 5: r = sdiv(a, b); break;
    case 6: r = smod(a, b); break;
    case 7: r = uexp(a, b); break;
    case 8: {
      if (is_zero(c)) { r = U256{}; break; }
      uint64_t wide[8] = {0};
      unsigned __int128 cc = 0;
      for (int i = 0; i < 4; ++i) {
        cc += (unsigned __int128)a.w[i] + b.w[i];
        wide[i] = (uint64_t)cc;
        cc >>= 64;
      }
      wide[4] = (uint64_t)cc;
      r = mod512(wide, c);
      break;
    }
    case 9: {
      if (is_zero(c)) { r = U256{}; break; }
      uint64_t wide[8];
      mul_full(a, b, wide);
      r = mod512(wide, c);
      break;
    }
    case 10: r = signextend(a, b); break;
    case 11: r = byte_at(a, b); break;
    case 12: r = (a.w[1] | a.w[2] | a.w[3] || a.w[0] >= 256) ? U256{} : shl(b, (unsigned)a.w[0]); break;
    case 13: r = (a.w[1] | a.w[2] | a.w[3] || a.w[0] >= 256) ? U256{} : shr(b, (unsigned)a.w[0]); break;
    case 14: r = sar(b, (a.w[1] | a.w[2] | a.w[3] || a.w[0] >= 256) ? 256 : (unsigned)a.w[0]); break;
    default: break;
  }
  to_be32(r, out32);
}

}  // extern "C"
