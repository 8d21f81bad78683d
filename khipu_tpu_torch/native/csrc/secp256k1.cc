// secp256k1 curve arithmetic (mod-p field + Jacobian points) in C++.
//
// Role parity: the reference leans on spongycastle's native-speed ECDSA
// (crypto/ECDSASignature.scala:115 recover with cached Q precompute).
// Python keeps the protocol layer (RFC 6979, recid bookkeeping, mod-n
// scalar algebra — a handful of big-int ops per signature); this file
// supplies the hot part: double-scalar multiplication k1*A + k2*B over
// the curve, which dominates recover/verify/ECDH at ~4k field
// multiplications each.
//
// Field: p = 2^256 - 2^32 - 977. 4x64-bit limbs, little-endian;
// products reduce via the special form (fold high limbs times
// 2^32 + 977 into the low half).
//
// C ABI (ctypes, khipu_tpu_torch/base/secp256k1.py):
//   khipu_ec_mul_add(ax, ay, k1, bx, by, k2, outx, outy) -> int
//     computes k1*A + k2*B; a null ax means A = G (same for bx).
//     k = NULL or zero skips that term. Returns 0 on success, 1 if the
//     result is the point at infinity.

#include <cstdint>
#include <cstring>

namespace {

typedef unsigned __int128 u128;

struct Fe {
  uint64_t v[4];
};

constexpr Fe P = {{0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                   0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
// 2^256 mod p = 2^32 + 977
constexpr uint64_t kFold = 0x1000003D1ULL;

constexpr Fe GX = {{0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
                    0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL}};
constexpr Fe GY = {{0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
                    0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL}};

inline bool fe_is_zero(const Fe& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

inline int fe_cmp(const Fe& a, const Fe& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] < b.v[i]) return -1;
    if (a.v[i] > b.v[i]) return 1;
  }
  return 0;
}

inline void fe_sub_p_if_ge(Fe& a) {
  if (fe_cmp(a, P) >= 0) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
      u128 d = (u128)a.v[i] - P.v[i] - (uint64_t)borrow;
      a.v[i] = (uint64_t)d;
      borrow = (d >> 64) ? 1 : 0;
    }
  }
}

inline void fe_add(Fe& r, const Fe& a, const Fe& b) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + (uint64_t)carry;
    r.v[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry) {  // fold 2^256 -> kFold
    u128 s = (u128)r.v[0] + kFold;
    r.v[0] = (uint64_t)s;
    u128 c = s >> 64;
    for (int i = 1; c && i < 4; ++i) {
      s = (u128)r.v[i] + (uint64_t)c;
      r.v[i] = (uint64_t)s;
      c = s >> 64;
    }
  }
  fe_sub_p_if_ge(r);
}

inline void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  u128 borrow = 0;
  Fe t;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - (uint64_t)borrow;
    t.v[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {  // add p back
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t.v[i] + P.v[i] + (uint64_t)carry;
      t.v[i] = (uint64_t)s;
      carry = s >> 64;
    }
  }
  r = t;
}

// full 256x256 -> 512 multiply, then fold twice
void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  uint64_t w[8] = {0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a.v[i] * b.v[j] + w[i + j] + (uint64_t)carry;
      w[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    w[i + 4] += (uint64_t)carry;
  }
  // fold high half: r = low + high * kFold (kFold < 2^33 so the
  // product of a 256-bit high by kFold is < 2^290; do it limbwise)
  uint64_t low[5] = {w[0], w[1], w[2], w[3], 0};
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)w[4 + i] * kFold + low[i] + (uint64_t)carry;
    low[i] = (uint64_t)cur;
    carry = cur >> 64;
  }
  low[4] = (uint64_t)carry;
  // second fold of the (small) overflow limb
  u128 cur = (u128)low[4] * kFold + low[0];
  Fe t;
  t.v[0] = (uint64_t)cur;
  u128 c = cur >> 64;
  for (int i = 1; i < 4; ++i) {
    u128 s = (u128)low[i] + (uint64_t)c;
    t.v[i] = (uint64_t)s;
    c = s >> 64;
  }
  if (c) {  // one more tiny fold
    u128 s = (u128)t.v[0] + kFold;
    t.v[0] = (uint64_t)s;
    u128 c2 = s >> 64;
    for (int i = 1; c2 && i < 4; ++i) {
      s = (u128)t.v[i] + (uint64_t)c2;
      t.v[i] = (uint64_t)s;
      c2 = s >> 64;
    }
  }
  fe_sub_p_if_ge(t);
  r = t;
}

inline void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

void fe_pow(Fe& r, const Fe& base, const Fe& exp) {
  Fe result = {{1, 0, 0, 0}};
  Fe b = base;
  for (int limb = 0; limb < 4; ++limb) {
    uint64_t e = exp.v[limb];
    for (int bit = 0; bit < 64; ++bit) {
      if (e & 1) fe_mul(result, result, b);
      e >>= 1;
      fe_sqr(b, b);
    }
  }
  r = result;
}

void fe_inv(Fe& r, const Fe& a) {
  Fe p2 = P;
  // p - 2
  p2.v[0] -= 2;  // no borrow: low limb ends ...FC2F
  fe_pow(r, a, p2);
}

// Jacobian point; inf encoded as z == 0
struct Pt {
  Fe x, y, z;
};

inline bool pt_is_inf(const Pt& p) { return fe_is_zero(p.z); }

void pt_double(Pt& r, const Pt& p) {
  if (pt_is_inf(p) || fe_is_zero(p.y)) {
    r = {{{0}}, {{0}}, {{0}}};
    return;
  }
  Fe ysq, s, m, t;
  fe_sqr(ysq, p.y);
  fe_mul(s, p.x, ysq);
  Fe four = {{4, 0, 0, 0}};
  fe_mul(s, s, four);
  fe_sqr(m, p.x);
  Fe three = {{3, 0, 0, 0}};
  fe_mul(m, m, three);
  Fe x2, two = {{2, 0, 0, 0}};
  fe_sqr(x2, m);
  fe_mul(t, s, two);
  fe_sub(x2, x2, t);
  Fe y2, ysq2, eight = {{8, 0, 0, 0}};
  fe_sub(t, s, x2);
  fe_mul(y2, m, t);
  fe_sqr(ysq2, ysq);
  fe_mul(ysq2, ysq2, eight);
  fe_sub(y2, y2, ysq2);
  Fe z2;
  fe_mul(z2, p.y, p.z);
  fe_mul(z2, z2, two);
  r.x = x2;
  r.y = y2;
  r.z = z2;
}

void pt_add(Pt& r, const Pt& p, const Pt& q) {
  if (pt_is_inf(p)) { r = q; return; }
  if (pt_is_inf(q)) { r = p; return; }
  Fe z1z1, z2z2, u1, u2, s1, s2;
  fe_sqr(z1z1, p.z);
  fe_sqr(z2z2, q.z);
  fe_mul(u1, p.x, z2z2);
  fe_mul(u2, q.x, z1z1);
  Fe t;
  fe_mul(t, q.z, z2z2);
  fe_mul(s1, p.y, t);
  fe_mul(t, p.z, z1z1);
  fe_mul(s2, q.y, t);
  if (fe_cmp(u1, u2) == 0) {
    if (fe_cmp(s1, s2) != 0) {
      r = {{{0}}, {{0}}, {{0}}};
      return;
    }
    pt_double(r, p);
    return;
  }
  Fe h, rr, hh, hhh, v;
  fe_sub(h, u2, u1);
  fe_sub(rr, s2, s1);
  fe_sqr(hh, h);
  fe_mul(hhh, h, hh);
  fe_mul(v, u1, hh);
  Fe x3, two = {{2, 0, 0, 0}};
  fe_sqr(x3, rr);
  fe_sub(x3, x3, hhh);
  fe_mul(t, v, two);
  fe_sub(x3, x3, t);
  Fe y3;
  fe_sub(t, v, x3);
  fe_mul(y3, rr, t);
  Fe s1hhh;
  fe_mul(s1hhh, s1, hhh);
  fe_sub(y3, y3, s1hhh);
  Fe z3;
  fe_mul(z3, p.z, q.z);
  fe_mul(z3, z3, h);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// mixed addition: q is affine (z == 1) — saves ~4 field muls per add
// versus the general Jacobian formula (the ladder's adds are all
// against precomputed tables, so this is the common case)
void pt_add_affine(Pt& r, const Pt& p, const Fe& qx, const Fe& qy) {
  if (pt_is_inf(p)) {
    r.x = qx;
    r.y = qy;
    r.z = {{1, 0, 0, 0}};
    return;
  }
  Fe z1z1, u2, s2, t;
  fe_sqr(z1z1, p.z);
  fe_mul(u2, qx, z1z1);
  fe_mul(t, p.z, z1z1);
  fe_mul(s2, qy, t);
  if (fe_cmp(p.x, u2) == 0) {
    if (fe_cmp(p.y, s2) != 0) {
      r = {{{0}}, {{0}}, {{0}}};
      return;
    }
    pt_double(r, p);
    return;
  }
  Fe h, rr, hh, hhh, v;
  fe_sub(h, u2, p.x);
  fe_sub(rr, s2, p.y);
  fe_sqr(hh, h);
  fe_mul(hhh, h, hh);
  fe_mul(v, p.x, hh);
  Fe x3, two = {{2, 0, 0, 0}};
  fe_sqr(x3, rr);
  fe_sub(x3, x3, hhh);
  fe_mul(t, v, two);
  fe_sub(x3, x3, t);
  Fe y3;
  fe_sub(t, v, x3);
  fe_mul(y3, rr, t);
  Fe s1hhh;
  fe_mul(s1hhh, p.y, hhh);
  fe_sub(y3, y3, s1hhh);
  Fe z3;
  fe_mul(z3, p.z, h);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// ------------------------------------------------------ wNAF machinery
//
// Width-4 non-adjacent form: odd digits in [-15, 15], ~1/5 density, so
// a 256-bit scalar costs ~256 doublings + ~51 table adds instead of the
// double-and-add ladder's ~128 adds. Both scalars of a double-scalar
// multiplication share ONE doubling ladder (Strauss-Shamir), which is
// where the 2x over two independent ladders comes from.

int wnaf4(int8_t out[260], const Fe& k) {
  uint64_t d[5] = {k.v[0], k.v[1], k.v[2], k.v[3], 0};
  int len = 0;
  auto nonzero = [&]() {
    return (d[0] | d[1] | d[2] | d[3] | d[4]) != 0;
  };
  while (nonzero()) {
    int8_t digit = 0;
    if (d[0] & 1) {
      int m = (int)(d[0] & 31);
      digit = (int8_t)((m > 16) ? m - 32 : m);
      if (digit >= 0) {
        uint64_t borrow = (uint64_t)digit;
        for (int i = 0; i < 5 && borrow; ++i) {
          uint64_t nv = d[i] - borrow;
          borrow = (nv > d[i]) ? 1 : 0;
          d[i] = nv;
        }
      } else {
        uint64_t carry = (uint64_t)(-digit);
        for (int i = 0; i < 5 && carry; ++i) {
          uint64_t nv = d[i] + carry;
          carry = (nv < d[i]) ? 1 : 0;
          d[i] = nv;
        }
      }
    }
    out[len++] = digit;
    // shift right one bit
    for (int i = 0; i < 4; ++i) d[i] = (d[i] >> 1) | (d[i + 1] << 63);
    d[4] >>= 1;
  }
  return len;
}

struct OddTable {  // 1P, 3P, 5P, ..., 15P (Jacobian)
  Pt p[8];
};

void odd_table(OddTable& t, const Pt& base) {
  t.p[0] = base;
  Pt twoP;
  pt_double(twoP, base);
  for (int i = 1; i < 8; ++i) pt_add(t.p[i], t.p[i - 1], twoP);
}

struct AffTable {  // affine odd multiples (for the fixed base G)
  Fe x[8], y[8];
};

const AffTable& g_table() {
  static AffTable t = [] {
    AffTable a;
    OddTable j;
    Pt g = {GX, GY, {{1, 0, 0, 0}}};
    odd_table(j, g);
    for (int i = 0; i < 8; ++i) {  // one-time: plain per-point inverts
      Fe zinv, zinv2, zinv3;
      fe_inv(zinv, j.p[i].z);
      fe_sqr(zinv2, zinv);
      fe_mul(zinv3, zinv2, zinv);
      fe_mul(a.x[i], j.p[i].x, zinv2);
      fe_mul(a.y[i], j.p[i].y, zinv3);
    }
    return a;
  }();
  return t;
}

// acc = k1*G + k2*B, one shared doubling ladder (either term optional)
void strauss(Pt& acc, const Fe* k1, const Pt* B, const Fe* k2) {
  int8_t w1[260], w2[260];
  int l1 = 0, l2 = 0;
  if (k1) l1 = wnaf4(w1, *k1);
  OddTable bt;
  if (k2) {
    l2 = wnaf4(w2, *k2);
    odd_table(bt, *B);
  }
  const AffTable& gt = g_table();
  acc = {{{0}}, {{0}}, {{0}}};
  int len = l1 > l2 ? l1 : l2;
  for (int i = len - 1; i >= 0; --i) {
    pt_double(acc, acc);
    if (i < l1 && w1[i]) {
      int d = w1[i];
      int idx = (d > 0 ? d : -d) >> 1;
      if (d > 0) {
        pt_add_affine(acc, acc, gt.x[idx], gt.y[idx]);
      } else {
        Fe ny;
        fe_sub(ny, P, gt.y[idx]);
        pt_add_affine(acc, acc, gt.x[idx], ny);
      }
    }
    if (i < l2 && w2[i]) {
      int d = w2[i];
      int idx = (d > 0 ? d : -d) >> 1;
      Pt q = bt.p[idx];
      if (d < 0) fe_sub(q.y, P, q.y);
      pt_add(acc, acc, q);
    }
  }
}

void fe_from_be(Fe& r, const uint8_t* b) {
  for (int i = 0; i < 4; ++i) {
    uint64_t limb = 0;
    for (int j = 0; j < 8; ++j) limb = (limb << 8) | b[(3 - i) * 8 + j];
    r.v[i] = limb;
  }
}

void fe_to_be(uint8_t* b, const Fe& a) {
  for (int i = 0; i < 4; ++i) {
    uint64_t limb = a.v[3 - i];
    for (int j = 7; j >= 0; --j) {
      b[i * 8 + j] = (uint8_t)limb;
      limb >>= 8;
    }
  }
}

// ------------------------------------------- scalar field (mod N) ----
//
// The group order n is NOT of the special 2^256-small form, but
// 2^256 mod n = C fits 129 bits ({C0, C1, 1, 0} limbs), so a 512-bit
// product reduces by folding the high half times C — same technique as
// the base field, one extra round.

constexpr Fe N_ORD = {{0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
                       0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL}};
constexpr uint64_t NC0 = 0x402DA1732FC9BEBFULL;
constexpr uint64_t NC1 = 0x4551231950B75FC4ULL;
constexpr uint64_t NC2 = 1ULL;

inline void sn_sub_n_if_ge(Fe& a) {
  bool ge = true;
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] > N_ORD.v[i]) break;
    if (a.v[i] < N_ORD.v[i]) { ge = false; break; }
  }
  if (ge) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
      u128 d = (u128)a.v[i] - N_ORD.v[i] - (uint64_t)borrow;
      a.v[i] = (uint64_t)d;
      borrow = (d >> 64) ? 1 : 0;
    }
  }
}

// w[0..7] (512-bit) -> Fe mod n
void sn_reduce512(Fe& r, const uint64_t w[8]) {
  const uint64_t C[3] = {NC0, NC1, NC2};
  // t = low4 + high4 * C  (4+3 limb product -> up to 7 limbs)
  uint64_t t[8] = {w[0], w[1], w[2], w[3], 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 3; ++j) {
      u128 cur = (u128)w[4 + i] * C[j] + t[i + j] + (uint64_t)carry;
      t[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    int idx = i + 3;
    while (carry) {
      u128 cur = (u128)t[idx] + (uint64_t)carry;
      t[idx] = (uint64_t)cur;
      carry = cur >> 64;
      ++idx;
    }
  }
  // fold t[4..6] (<= ~2^131) * C again
  uint64_t t2[6] = {t[0], t[1], t[2], t[3], 0, 0};
  for (int i = 0; i < 3; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 3; ++j) {
      u128 cur = (u128)t[4 + i] * C[j] + t2[i + j] + (uint64_t)carry;
      t2[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    int idx = i + 3;
    while (carry && idx < 6) {
      u128 cur = (u128)t2[idx] + (uint64_t)carry;
      t2[idx] = (uint64_t)cur;
      carry = cur >> 64;
      ++idx;
    }
  }
  // final tiny fold of t2[4..5] (at most a few bits)
  Fe out = {{t2[0], t2[1], t2[2], t2[3]}};
  while (t2[4] | t2[5]) {
    uint64_t hi[2] = {t2[4], t2[5]};
    t2[4] = t2[5] = 0;
    u128 carry = 0;
    uint64_t acc[6] = {out.v[0], out.v[1], out.v[2], out.v[3], 0, 0};
    for (int i = 0; i < 2; ++i) {
      carry = 0;
      for (int j = 0; j < 3; ++j) {
        u128 cur = (u128)hi[i] * C[j] + acc[i + j] + (uint64_t)carry;
        acc[i + j] = (uint64_t)cur;
        carry = cur >> 64;
      }
      int idx = i + 3;
      while (carry && idx < 6) {
        u128 cur = (u128)acc[idx] + (uint64_t)carry;
        acc[idx] = (uint64_t)cur;
        carry = cur >> 64;
        ++idx;
      }
    }
    out = {{acc[0], acc[1], acc[2], acc[3]}};
    t2[4] = acc[4];
    t2[5] = acc[5];
  }
  sn_sub_n_if_ge(out);
  sn_sub_n_if_ge(out);
  r = out;
}

void sn_mul(Fe& r, const Fe& a, const Fe& b) {
  uint64_t w[8] = {0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a.v[i] * b.v[j] + w[i + j] + (uint64_t)carry;
      w[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    w[i + 4] += (uint64_t)carry;
  }
  sn_reduce512(r, w);
}

void sn_inv(Fe& r, const Fe& a) {  // a^(n-2) mod n
  Fe e = N_ORD;
  e.v[0] -= 2;  // low limb ends ...4141, no borrow
  Fe result = {{1, 0, 0, 0}};
  Fe b = a;
  for (int limb = 0; limb < 4; ++limb) {
    uint64_t bits = e.v[limb];
    for (int bit = 0; bit < 64; ++bit) {
      if (bits & 1) sn_mul(result, result, b);
      bits >>= 1;
      sn_mul(b, b, b);
    }
  }
  r = result;
}

inline bool sn_is_zero_or_ge_n(const Fe& a) {
  if (fe_is_zero(a)) return true;
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] > N_ORD.v[i]) return true;
    if (a.v[i] < N_ORD.v[i]) return false;
  }
  return true;  // equal
}

// sqrt mod p via a^((p+1)/4) (p = 3 mod 4); returns false if a is a
// non-residue (caller re-checks y^2 == a)
void fe_sqrt(Fe& r, const Fe& a) {
  // (p+1)/4 = 2^254 - 2^30 - 244
  constexpr Fe E = {{0xFFFFFFFFBFFFFF0CULL, 0xFFFFFFFFFFFFFFFFULL,
                     0xFFFFFFFFFFFFFFFFULL, 0x3FFFFFFFFFFFFFFFULL}};
  fe_pow(r, a, E);
}

}  // namespace

extern "C" {

// k1*A + k2*B in affine out coords. ax/bx NULL => that base is G.
// k1/k2 NULL or zero => term skipped. Returns 1 for infinity.
int khipu_ec_mul_add(const uint8_t* ax, const uint8_t* ay,
                     const uint8_t* k1, const uint8_t* bx,
                     const uint8_t* by, const uint8_t* k2,
                     uint8_t* outx, uint8_t* outy) {
  const Fe one = {{1, 0, 0, 0}};
  Fe s1, s2;
  const Fe* gk = nullptr;   // scalar on the G (fixed-base) ladder
  const Fe* vk = nullptr;   // scalar on the variable-base ladder
  Pt base;
  bool have_base = false;
  if (k1) {
    fe_from_be(s1, k1);
    if (!fe_is_zero(s1)) {
      if (ax) {
        fe_from_be(base.x, ax);
        fe_from_be(base.y, ay);
        base.z = one;
        have_base = true;
        vk = &s1;
      } else {
        gk = &s1;
      }
    }
  }
  if (k2) {
    fe_from_be(s2, k2);
    if (!fe_is_zero(s2)) {
      if (bx) {
        if (have_base) {
          // two distinct variable bases: fold the first into acc via
          // its own strauss pass (rare path — nothing hot uses it)
          Pt acc1;
          strauss(acc1, gk, &base, vk);
          Pt b2;
          fe_from_be(b2.x, bx);
          fe_from_be(b2.y, by);
          b2.z = one;
          Pt acc2;
          strauss(acc2, nullptr, &b2, &s2);
          Pt acc;
          pt_add(acc, acc1, acc2);
          if (pt_is_inf(acc)) return 1;
          Fe zinv, zinv2, zinv3, x, y;
          fe_inv(zinv, acc.z);
          fe_sqr(zinv2, zinv);
          fe_mul(zinv3, zinv2, zinv);
          fe_mul(x, acc.x, zinv2);
          fe_mul(y, acc.y, zinv3);
          fe_to_be(outx, x);
          fe_to_be(outy, y);
          return 0;
        }
        fe_from_be(base.x, bx);
        fe_from_be(base.y, by);
        base.z = one;
        have_base = true;
        vk = &s2;
      } else if (gk) {
        // both scalars on G: combine on one ladder is wrong (distinct
        // wNAFs); just run G twice via strauss's two slots
        Pt g = {GX, GY, one};
        base = g;
        have_base = true;
        vk = &s2;
      } else {
        gk = &s2;
      }
    }
  }
  Pt acc;
  strauss(acc, gk, have_base ? &base : nullptr,
          have_base ? vk : nullptr);
  if (pt_is_inf(acc)) return 1;
  Fe zinv, zinv2, zinv3, x, y;
  fe_inv(zinv, acc.z);
  fe_sqr(zinv2, zinv);
  fe_mul(zinv3, zinv2, zinv);
  fe_mul(x, acc.x, zinv2);
  fe_mul(y, acc.y, zinv3);
  fe_to_be(outx, x);
  fe_to_be(outy, y);
  return 0;
}

// Batched ECDSA public-key recovery — the tx-sender hot loop
// (SignedTransaction.scala:143 role). One C call per block amortizes
// ctypes overhead; a Strauss-Shamir wNAF-4 ladder computes
// u1*G + u2*R, and ONE Montgomery batch inversion converts every
// result to affine (saving a ~256-squaring field inversion per
// signature). msg: n*32 bytes; recid: n bytes (0-3); rs: n*64 bytes
// (r || s big-endian); out: n*64 bytes (x || y); ok: n bytes (1 =
// recovered, 0 = invalid signature). Returns the number recovered.
int khipu_ecdsa_recover_batch(int n, const uint8_t* msg,
                              const uint8_t* recid, const uint8_t* rs,
                              uint8_t* out, uint8_t* ok) {
  int good = 0;
  Pt* results = new Pt[n];
  int* live = new int[n];
  for (int i = 0; i < n; ++i) {
    ok[i] = 0;
    live[i] = 0;
    Fe r, s;
    fe_from_be(r, rs + 64 * i);
    fe_from_be(s, rs + 64 * i + 32);
    if (sn_is_zero_or_ge_n(r) || sn_is_zero_or_ge_n(s)) continue;
    int v = recid[i];
    if (v < 0 || v > 3) continue;
    // x = r (+ n for the high recids), must stay below p
    Fe x = r;
    if (v & 2) {
      u128 carry = 0;
      for (int j = 0; j < 4; ++j) {
        u128 cur = (u128)x.v[j] + N_ORD.v[j] + (uint64_t)carry;
        x.v[j] = (uint64_t)cur;
        carry = cur >> 64;
      }
      if (carry || fe_cmp(x, P) >= 0) continue;
    }
    // y^2 = x^3 + 7
    Fe x2, x3, alpha, seven = {{7, 0, 0, 0}};
    fe_sqr(x2, x);
    fe_mul(x3, x2, x);
    fe_add(alpha, x3, seven);
    Fe y;
    fe_sqrt(y, alpha);
    Fe y2;
    fe_sqr(y2, y);
    if (fe_cmp(y2, alpha) != 0) continue;  // non-residue: invalid
    if ((int)(y.v[0] & 1) != (v & 1)) fe_sub(y, P, y);
    // scalars: u1 = -z/r, u2 = s/r (mod n)
    Fe z;
    fe_from_be(z, msg + 32 * i);
    sn_sub_n_if_ge(z);
    Fe rinv, u1, u2;
    sn_inv(rinv, r);
    sn_mul(u1, z, rinv);
    if (!fe_is_zero(u1)) {  // u1 = n - z/r
      u128 borrow = 0;
      Fe t;
      for (int j = 0; j < 4; ++j) {
        u128 d = (u128)N_ORD.v[j] - u1.v[j] - (uint64_t)borrow;
        t.v[j] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
      }
      u1 = t;
    }
    sn_mul(u2, s, rinv);
    Pt R = {x, y, {{1, 0, 0, 0}}};
    Pt q;
    strauss(q, fe_is_zero(u1) ? nullptr : &u1, &R,
            fe_is_zero(u2) ? nullptr : &u2);
    if (pt_is_inf(q)) continue;
    results[i] = q;
    live[i] = 1;
  }
  // Montgomery batch inversion of every live z
  Fe* prefix = new Fe[n];
  Fe run = {{1, 0, 0, 0}};
  for (int i = 0; i < n; ++i) {
    if (!live[i]) continue;
    prefix[i] = run;
    fe_mul(run, run, results[i].z);
  }
  Fe run_inv;
  fe_inv(run_inv, run);
  for (int i = n - 1; i >= 0; --i) {
    if (!live[i]) continue;
    Fe zinv;
    fe_mul(zinv, run_inv, prefix[i]);
    fe_mul(run_inv, run_inv, results[i].z);
    Fe zinv2, zinv3, xo, yo;
    fe_sqr(zinv2, zinv);
    fe_mul(zinv3, zinv2, zinv);
    fe_mul(xo, results[i].x, zinv2);
    fe_mul(yo, results[i].y, zinv3);
    fe_to_be(out + 64 * i, xo);
    fe_to_be(out + 64 * i + 32, yo);
    ok[i] = 1;
    ++good;
  }
  delete[] results;
  delete[] live;
  delete[] prefix;
  return good;
}

}  // extern "C"
