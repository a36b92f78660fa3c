"""`ecc` host module — ECC oracles (reference
``include/host_modules/ecc.hpp``).

Native point arithmetic over P-256 / secp256k1 / Ed25519; verification
constraints are emitted guest-side by the SDK.  Outputs land in guest
memory marked secret (``ecc.hpp:107-114,340,456-457``).
"""

from __future__ import annotations

import math

from ..values import WasmTrap

CURVE_P256 = 1
CURVE_SECP256K1 = 2
CURVE_ED25519 = 3

# P-256 (ecc.hpp:472-475)
P256_P = 0xffffffff00000001000000000000000000000000ffffffffffffffffffffffff
P256_N = 0xffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2fc632551
P256_B = 0x5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b

# secp256k1 (ecc.hpp:477-480); b = 7 so 3b = 21
SECP256K1_P = \
    0xfffffffffffffffffffffffffffffffffffffffffffffffffffffffefffffc2f
SECP256K1_N = \
    0xfffffffffffffffffffffffffffffffebaaedce6af48a03bbfd25e8cd0364141
SECP256K1_B3 = 21

# Ed25519 (ecc.hpp:482-485)
ED25519_P = 2**255 - 19
ED25519_N = 0x1000000000000000000000000000000014def9dea2f79cd65812631a5cf5d3ed
ED25519_D = 0x52036cee2b6ffe738cc740797779e89800700a4d4141d8ab75eb4dca135978a3

EINVAL = 22

_GROUP_ORDER = {CURVE_P256: P256_N, CURVE_SECP256K1: SECP256K1_N,
                CURVE_ED25519: ED25519_N}


def _weierstrass_add(p1, p2, p, b3_or_b, k1_form: bool):
    """Complete projective addition (Renes–Costello–Batina 2015):
    algorithm 4 (a=-3, P-256 — ``ecc.hpp:117-170``) or algorithm 7
    (a=0, secp256k1 — ``ecc.hpp:189-237``)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if not k1_form:
        b = b3_or_b
        t0 = X1 * X2 % p
        t1 = Y1 * Y2 % p
        t2 = Z1 * Z2 % p
        t3 = (X1 + Y1) * (X2 + Y2) % p
        t3 = (t3 - t0 - t1) % p
        t4 = (Y1 + Z1) * (Y2 + Z2) % p
        t4 = (t4 - t1 - t2) % p
        X3 = (X1 + Z1) * (X2 + Z2) % p
        Y3 = (X3 - t0 - t2) % p
        Z3 = b * t2 % p
        X3 = (Y3 - Z3) % p
        Z3 = 2 * X3 % p
        X3 = (X3 + Z3) % p
        Z3 = (t1 - X3) % p
        X3 = (t1 + X3) % p
        Y3 = b * Y3 % p
        t1 = 2 * t2 % p
        t2 = (t1 + t2) % p
        Y3 = (Y3 - t2 - t0) % p
        t1 = 2 * Y3 % p
        Y3 = (t1 + Y3) % p
        t1 = 2 * t0 % p
        t0 = (t1 + t0 - t2) % p
        t1 = t4 * Y3 % p
        t2 = t0 * Y3 % p
        Y3 = X3 * Z3 % p
        Y3 = (Y3 + t2) % p
        X3 = (t3 * X3 - t1) % p
        Z3 = (t4 * Z3 + t3 * t0) % p
        return (X3 % p, Y3 % p, Z3 % p)
    b3 = b3_or_b
    t0 = X1 * X2 % p
    t1 = Y1 * Y2 % p
    t2 = Z1 * Z2 % p
    t3 = (X1 + Y1) * (X2 + Y2) % p
    t3 = (t3 - t0 - t1) % p
    t4 = (Y1 + Z1) * (Y2 + Z2) % p
    t4 = (t4 - t1 - t2) % p
    X3 = (X1 + Z1) * (X2 + Z2) % p
    Y3 = (X3 - t0 - t2) % p
    X3 = 2 * t0 % p
    t0 = (X3 + t0) % p
    t2 = b3 * t2 % p
    Z3 = (t1 + t2) % p
    t1 = (t1 - t2) % p
    Y3 = b3 * Y3 % p
    X3 = (t3 * t1 - t4 * Y3) % p
    Y3 = (Y3 * t0 + t1 * Z3) % p
    Z3 = (Z3 * t4 + t0 * t3) % p
    return (X3, Y3, Z3)


def _weierstrass_scalar_mul(s, px, py, p, b3_or_b, k1_form):
    """255..0 MSB-first double-and-add ladder (``ecc.hpp:172-187``)."""
    acc = (0, 1, 0)
    point = (px, py, 1)
    for i in range(255, -1, -1):
        acc = _weierstrass_add(acc, acc, p, b3_or_b, k1_form)
        if (s >> i) & 1:
            acc = _weierstrass_add(acc, point, p, b3_or_b, k1_form)
    inv = pow(acc[2], -1, p)
    return (acc[0] * inv % p, acc[1] * inv % p)


def _ed25519_add(p1, p2):
    """Affine twisted-Edwards addition (``ecc.hpp:256-279``)."""
    p = ED25519_P
    x1y2 = p1[0] * p2[1] % p
    x2y1 = p2[0] * p1[1] % p
    y1y2 = p1[1] * p2[1] % p
    x1x2 = p1[0] * p2[0] % p
    dxy = ED25519_D * x1x2 % p * y1y2 % p
    x3 = (x1y2 + x2y1) * pow(1 + dxy, -1, p) % p
    y3 = (y1y2 + x1x2) * pow(1 - dxy, -1, p) % p
    return (x3, y3)


def _ed25519_scalar_mul(s, px, py):
    acc = (0, 1)
    for i in range(255, -1, -1):
        acc = _ed25519_add(acc, acc)
        if (s >> i) & 1:
            acc = _ed25519_add(acc, (px, py))
    return acc


def ed25519_point_decompress(enc: int):
    """RFC 8032 §5.1.3 decompression (``ecc.hpp:343-417``); returns
    (x, y) or None."""
    p = ED25519_P
    x0 = (enc >> 255) & 1
    y = enc & ~(1 << 255)
    if y >= p:
        return None
    yy = y * y % p
    u = (yy - 1) % p
    v = (ED25519_D * yy + 1) % p
    try:
        v_inv = pow(v, -1, p)
    except ValueError:
        return None
    x = pow(u * v_inv % p, (p + 3) // 8, p)
    vxx = v * x % p * x % p
    if vxx == u:
        pass
    elif vxx == (-u) % p:
        x = x * pow(2, (p - 1) // 4, p) % p
        if v * x % p * x % p != u:
            return None
    else:
        return None
    if x == 0 and x0:
        return None
    if (x & 1) != x0:
        x = p - x
    return (x, y)


class EccModule:
    name = "ecc"

    def __init__(self, ctx):
        self.ctx = ctx

    def call(self, func: str):
        handler = getattr(self, func, None)
        if handler is None:
            raise WasmTrap(f"ecc.{func} not implemented")
        handler()

    def _pop_u32(self) -> int:
        return self.ctx.make_numeric(self.ctx.pop()).as_u32()

    def _store_le(self, addr: int, v: int, width: int):
        """Zero-padded little-endian store (the reference mpz_exports only
        the minimal bytes into a guest-zeroed buffer — ``ecc.hpp:106``;
        padding is equivalent for pre-zeroed buffers and strictly safer)."""
        self.ctx.memory.store_bytes(addr, v.to_bytes(width, "little"))

    # -- host functions ------------------------------------------------------

    def scalar_decompose(self):
        """Half-GCD scalar split for the MSM trick: partial extended
        Euclid on (group order, k) stopping at r1 < sqrt(r); outputs
        (|r1|, sgn r1, |t1|, sgn t1) marked secret (``ecc.hpp:53-115``)."""
        ctx = self.ctx
        num_k_bytes = self._pop_u32()
        k_bytes_addr = self._pop_u32()
        z_sgn_addr = self._pop_u32()
        z_abs_addr = self._pop_u32()
        x_sgn_addr = self._pop_u32()
        x_abs_addr = self._pop_u32()
        curve_type = self._pop_u32()

        r = _GROUP_ORDER.get(curve_type)
        if r is None:
            raise WasmTrap(f"ecc: unexpected curve type {curve_type}")
        k = int.from_bytes(ctx.memory.load_bytes(k_bytes_addr, num_k_bytes),
                           "little")

        r0, s0, t0 = r, 1, 0
        r1, s1, t1 = k, 0, 1
        limit = math.isqrt(r)
        while r1 >= limit:
            q = r0 // r1
            r0, r1 = r1, r0 - q * r1
            s0, s1 = s1, s0 - q * s1
            t0, t1 = t1, t0 - q * t1

        self._store_le(x_sgn_addr, int(r1 >= 0), 4)
        self._store_le(x_abs_addr, abs(r1), 16)
        ctx.memory.mark_secret(x_sgn_addr, x_sgn_addr + 4)
        ctx.memory.mark_secret(x_abs_addr, x_abs_addr + 16)

        self._store_le(z_sgn_addr, int(t1 >= 0), 4)
        self._store_le(z_abs_addr, abs(t1), 16)
        ctx.memory.mark_secret(z_sgn_addr, z_sgn_addr + 4)
        ctx.memory.mark_secret(z_abs_addr, z_abs_addr + 16)

    def scalar_mul(self):
        """Projective/Edwards double-and-add ladder oracle
        (``ecc.hpp:292-341``); result marked secret."""
        ctx = self.ctx
        num_s_bytes = self._pop_u32()
        s_addr = self._pop_u32()
        p_addr = self._pop_u32()
        out_addr = self._pop_u32()
        curve_type = self._pop_u32()

        fbs = 32
        px = int.from_bytes(ctx.memory.load_bytes(p_addr, fbs), "little")
        py = int.from_bytes(ctx.memory.load_bytes(p_addr + fbs, fbs),
                            "little")
        s = int.from_bytes(ctx.memory.load_bytes(s_addr, num_s_bytes),
                           "little")

        if curve_type == CURVE_P256:
            rx, ry = _weierstrass_scalar_mul(s, px, py, P256_P, P256_B,
                                             False)
        elif curve_type == CURVE_SECP256K1:
            rx, ry = _weierstrass_scalar_mul(s, px, py, SECP256K1_P,
                                             SECP256K1_B3, True)
        elif curve_type == CURVE_ED25519:
            rx, ry = _ed25519_scalar_mul(s, px, py)
        else:
            raise WasmTrap(f"ecc: unexpected curve type {curve_type}")

        self._store_le(out_addr, rx, fbs)
        self._store_le(out_addr + fbs, ry, fbs)
        ctx.memory.mark_secret(out_addr, out_addr + 2 * fbs)

    def point_decompress(self):
        """Ed25519 point decompression oracle; pushes a *witness* error
        code (0 / EINVAL) and marks outputs secret (``ecc.hpp:419-458``)."""
        ctx = self.ctx
        enc_addr = self._pop_u32()
        y_addr = self._pop_u32()
        x_addr = self._pop_u32()
        curve_type = self._pop_u32()

        fbs = 32
        enc = int.from_bytes(ctx.memory.load_bytes(enc_addr, fbs), "little")

        errc = 0
        if curve_type == CURVE_ED25519:
            point = ed25519_point_decompress(enc)
            if point is not None:
                self._store_le(x_addr, point[0], fbs)
                self._store_le(y_addr, point[1], fbs)
            else:
                errc = EINVAL
        else:
            raise WasmTrap(f"ecc: unexpected curve type {curve_type}")

        ctx.push(ctx.backend.acquire_witness(errc))
        ctx.memory.mark_secret(x_addr, x_addr + fbs)
        ctx.memory.mark_secret(y_addr, y_addr + fbs)

    def finalize(self):
        pass
