"""alt_bn128 curve ops + optimal-ate pairing (EIP-196/197 precompiles).

Role of the reference's zkSNARK math (crypto/zksnark/BN128.scala:33,
Fp12.scala, PairingCheck.scala — an EthereumJ port). Tower:
Fp2 = Fp[i]/(i^2+1), Fp12 = Fp2[w]/(w^6 - (9+i)) flattened as
Fp[w]/(w^12 - 18 w^6 + 82). G1 on y^2 = x^3 + 3 over Fp; G2 on the
sextic twist y^2 = x^3 + 3/(9+i) over Fp2.

Precompile wrappers return None for malformed input (not-on-curve /
not-in-subgroup), which the caller maps to consuming all gas.
Correctness is pinned by bilinearity/self-consistency tests rather than
external vectors (tests/test_evm.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
CURVE_ORDER = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

# ------------------------------------------------------------------ Fp2

Fp2 = Tuple[int, int]  # a + b*i

F2_ZERO: Fp2 = (0, 0)
F2_ONE: Fp2 = (1, 0)


def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    # (a0 + a1 i)(b0 + b1 i), i^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_scalar(a: Fp2, k: int) -> Fp2:
    return (a[0] * k % P, a[1] * k % P)


def f2_neg(a: Fp2) -> Fp2:
    return (-a[0] % P, -a[1] % P)


def f2_inv(a: Fp2) -> Fp2:
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return (a[0] * ninv % P, -a[1] * ninv % P)


# 3 / (9 + i) — the twist curve's B coefficient
TWIST_B: Fp2 = f2_mul((3, 0), f2_inv((9, 1)))

# ----------------------------------------------------------- Fp12 poly
# Elements are 12-coefficient lists over Fp modulo w^12 - 18 w^6 + 82.

Fp12 = List[int]

F12_ONE: Fp12 = [1] + [0] * 11


def f12_mul(a: Fp12, b: Fp12) -> Fp12:
    t = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                t[i + j] += ai * bj
    # reduce degree >= 12: w^12 = 18 w^6 - 82
    for i in range(22, 11, -1):
        v = t[i]
        if v:
            t[i] = 0
            t[i - 6] += 18 * v
            t[i - 12] -= 82 * v
    return [x % P for x in t[:12]]


def f12_pow(a: Fp12, e: int) -> Fp12:
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_mul(base, base)
        e >>= 1
    return out


def _f12_from_fp2_pair(c0: Fp2, shift: int) -> Fp12:
    """Embed x0 + x1*i (twisted basis) at w^shift: the Fp2 element
    (x0, x1) maps to (x0 - 9 x1) * w^shift + x1 * w^(shift+6)."""
    out = [0] * 12
    out[shift] = (c0[0] - 9 * c0[1]) % P
    out[shift + 6] = c0[1] % P
    return out


# -------------------------------------------------------------- points
# Affine points; None = infinity. G1 coords are ints, G2 coords Fp2.


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(p, k: int):
    out = None
    add = p
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


def g1_neg(p):
    return None if p is None else (p[0], -p[1] % P)


def on_g1(p) -> bool:
    if p is None:
        return True
    x, y = p
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - x * x * x - 3) % P == 0


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_mul(x1, x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_mul(p, k: int):
    out = None
    add = p
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def on_g2_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = f2_mul(y, y)
    rhs = f2_add(f2_mul(f2_mul(x, x), x), TWIST_B)
    return lhs == rhs


def in_g2_subgroup(p) -> bool:
    return on_g2_curve(p) and g2_mul(p, CURVE_ORDER) is None


# ------------------------------------------------------------- pairing
# Miller loop over the twist embedded into Fp12 (py_ecc-style layout:
# G2 x at w^2, y at w^3).


def _twist(q):
    if q is None:
        return None
    x, y = q
    nx = _f12_from_fp2_pair(x, 2)
    ny = _f12_from_fp2_pair(y, 3)
    return (nx, ny)


def _f12_add(a: Fp12, b: Fp12) -> Fp12:
    return [(x + y) % P for x, y in zip(a, b)]


def _f12_sub(a: Fp12, b: Fp12) -> Fp12:
    return [(x - y) % P for x, y in zip(a, b)]


def _f12_inv(a: Fp12) -> Fp12:
    # extended Euclid over the polynomial ring mod w^12 - 18w^6 + 82
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0, 1]

    def deg(p):
        for i in range(len(p) - 1, -1, -1):
            if p[i]:
                return i
        return 0

    def poly_rounded_div(aa, bb):
        dega, degb = deg(aa), deg(bb)
        temp = list(aa)
        out = [0] * len(aa)
        binv = pow(bb[degb], P - 2, P)
        for i in range(dega - degb, -1, -1):
            out[i] = (out[i] + temp[degb + i] * binv) % P
            for c in range(degb + 1):
                temp[c + i] = (temp[c + i] - out[i] * bb[c]) % P
        return out[: deg(out) + 1]

    while deg(low):
        r = poly_rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm = list(hm)
        new = list(high)
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] = (nm[i + j] - lm[i] * r[j]) % P
                new[i + j] = (new[i + j] - low[i] * r[j]) % P
        lm, low, hm, high = nm, new, lm, low
    inv0 = pow(low[0], P - 2, P)
    return [c * inv0 % P for c in lm[:12]]


def _g12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if _f12_add(y1, y2) == [0] * 12:
            return None
        num = f12_mul([3] + [0] * 11, f12_mul(x1, x1))
        den = f12_mul([2] + [0] * 11, y1)
        lam = f12_mul(num, _f12_inv(den))
    else:
        lam = f12_mul(_f12_sub(y2, y1), _f12_inv(_f12_sub(x2, x1)))
    x3 = _f12_sub(_f12_sub(f12_mul(lam, lam), x1), x2)
    return (x3, _f12_sub(f12_mul(lam, _f12_sub(x1, x3)), y1))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at point t (all in Fp12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = f12_mul(_f12_sub(y2, y1), _f12_inv(_f12_sub(x2, x1)))
        return _f12_sub(f12_mul(m, _f12_sub(xt, x1)), _f12_sub(yt, y1))
    if y1 == y2:
        m = f12_mul(
            f12_mul([3] + [0] * 11, f12_mul(x1, x1)),
            _f12_inv(f12_mul([2] + [0] * 11, y1)),
        )
        return _f12_sub(f12_mul(m, _f12_sub(xt, x1)), _f12_sub(yt, y1))
    return _f12_sub(xt, x1)


def _f12_frobenius_point(pt):
    """(x, y) -> (x^p, y^p) coefficient-wise via f12_pow."""
    return (f12_pow(pt[0], P), f12_pow(pt[1], P))


def _f12_embed_g1(p):
    return ([p[0]] + [0] * 11, [p[1]] + [0] * 11)


def miller_loop(q, p) -> Fp12:
    """e(P in G1, Q in G2) without the final check; q/p affine,
    non-infinity, already embedded in Fp12."""
    r = q
    f = F12_ONE
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f12_mul(f12_mul(f, f), _linefunc(r, r, p))
        r = _g12_add(r, r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f12_mul(f, _linefunc(r, q, p))
            r = _g12_add(r, q)
    q1 = _f12_frobenius_point(q)
    nq2 = _f12_frobenius_point(q1)
    nq2 = (nq2[0], [(-c) % P for c in nq2[1]])
    f = f12_mul(f, _linefunc(r, q1, p))
    r = _g12_add(r, q1)
    f = f12_mul(f, _linefunc(r, nq2, p))
    return f


_FINAL_EXP = (P**12 - 1) // CURVE_ORDER


def pairing(q, p) -> Fp12:
    """Full pairing e(p1 in G1, q2 in G2) -> Fp12 (unit group)."""
    if p is None or q is None:
        return F12_ONE
    return f12_pow(miller_loop(_twist(q), _f12_embed_g1(p)), _FINAL_EXP)


def pairing_product_is_one(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod e(Pi, Qi) == 1 — evaluated as a product of miller loops with
    one shared final exponentiation."""
    acc = F12_ONE
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        acc = f12_mul(acc, miller_loop(_twist(q2), _f12_embed_g1(p1)))
    return f12_pow(acc, _FINAL_EXP) == F12_ONE


# --------------------------------------------------- precompile codecs


def _read_g1(data: bytes) -> Optional[object]:
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x >= P or y >= P:
        raise ValueError("coordinate >= field modulus")
    if x == 0 and y == 0:
        return None  # infinity encoding
    p = (x, y)
    if not on_g1(p):
        raise ValueError("not on G1")
    return p


def _write_g1(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def add_points(data: bytes) -> Optional[bytes]:
    data = data[:128].ljust(128, b"\x00")
    try:
        a = _read_g1(data[:64])
        b = _read_g1(data[64:128])
    except ValueError:
        return None
    return _write_g1(g1_add(a, b))


def mul_point(data: bytes) -> Optional[bytes]:
    data = data[:96].ljust(96, b"\x00")
    try:
        p = _read_g1(data[:64])
    except ValueError:
        return None
    k = int.from_bytes(data[64:96], "big")
    return _write_g1(g1_mul(p, k))


def pairing_check(data: bytes) -> Optional[bytes]:
    if len(data) % 192 != 0:
        return None
    pairs = []
    for off in range(0, len(data), 192):
        chunk = data[off : off + 192]
        try:
            p1 = _read_g1(chunk[:64])
        except ValueError:
            return None
        # G2 coords: (x_imag, x_real, y_imag, y_real) big-endian words
        xi = int.from_bytes(chunk[64:96], "big")
        xr = int.from_bytes(chunk[96:128], "big")
        yi = int.from_bytes(chunk[128:160], "big")
        yr = int.from_bytes(chunk[160:192], "big")
        if max(xi, xr, yi, yr) >= P:
            return None
        if xi == xr == yi == yr == 0:
            q2 = None
        else:
            q2 = ((xr, xi), (yr, yi))
            if not in_g2_subgroup(q2):
                return None
        pairs.append((p1, q2))
    ok = pairing_product_is_one(pairs)
    return (1 if ok else 0).to_bytes(32, "big")
