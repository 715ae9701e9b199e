"""Block partitioning and sub-block symbol offset math (RFC 6330 s4.4.1.2).

Parity: reference fill_partition / gen_scheme_specific / get_source_block /
get_symbol_offset (lib/nanorq.c:60-128).  Sub-block interleaving (N > 1) is
supported on read/write like the reference's decoder side; the encoder
defaults to N = 1 exactly as the reference does (nanorq.c:78).
"""

from dataclasses import dataclass

from nanorq_tpu_torch.rfc.tables import K_MAX, Z_MAX


def div_ceil(a: int, b: int) -> int:
    return a // b + (1 if a % b else 0)


@dataclass(frozen=True)
class Partition:
    """Partition[I, J]: JL long blocks of size IL, JS short of size IS."""

    IL: int
    IS: int
    JL: int
    JS: int

    @staticmethod
    def make(I: int, J: int) -> "Partition":
        if J == 0:
            return Partition(0, 0, 0, 0)
        IL = div_ceil(I, J)
        IS = I // J
        JL = I - IS * J
        JS = J - JL
        if JL == 0:
            IL = 0
        return Partition(IL, IS, JL, JS)

    def size(self, j: int) -> int:
        """Symbols in the j-th block (long blocks first)."""
        if j < self.JL:
            return self.IL
        if j - self.JL < self.JS:
            return self.IS
        return 0

    @property
    def count(self) -> int:
        return self.JL + self.JS


@dataclass(frozen=True)
class Scheme:
    """Object layout: F bytes as Z source blocks x N sub-blocks of T-byte symbols."""

    F: int
    T: int
    Al: int
    Z: int
    N: int
    Kt: int  # total source symbols = ceil(F / T)
    src: Partition  # Partition[Kt, Z]
    sub: Partition  # Partition[T/Al, N]

    def block_symbols(self, sbn: int) -> int:
        return self.src.size(sbn)

    @property
    def blocks(self) -> int:
        return self.src.count


def make_scheme(F: int, T: int, Al: int, K: int = 0, Z: int = 0, N: int = 1) -> Scheme:
    """Encoder-side scheme derivation (gen_scheme_specific, nanorq.c:60-81).

    Exactly one of K (symbols per block) or Z (number of blocks) may be
    given; 0 means derive.  N > 1 enables sub-block interleaving (the
    reference pins N=1 on encode, nanorq.c:78, but its decoder accepts N>1
    from the OTI; we support both sides).  Raises ValueError for infeasible
    layouts.
    """
    Kt = div_ceil(F, T)
    Kn = K
    if K == 0:
        Kn = Kt
        if Z == 0:
            Z = 16
            while div_ceil(Kt, Z) > K_MAX:
                Z += 1
        Kn = div_ceil(Kt, Z)
    Zb = div_ceil(Kt, Kn)
    if Zb == 0 or Zb > Z_MAX or div_ceil(Kt, Zb) > K_MAX:
        raise ValueError(f"infeasible partition: F={F} T={T} K={K} Z={Z}")
    if not (1 <= N <= max(1, T // Al)) or N > 1 << 16:
        raise ValueError(f"infeasible sub-blocking: N={N} with T={T} Al={Al}")
    return Scheme(
        F=F, T=T, Al=Al, Z=Zb, N=N, Kt=Kt,
        src=Partition.make(Kt, Zb),
        sub=Partition.make(T // Al, N),
    )


def scheme_from_oti(F: int, T: int, Al: int, Z: int, N: int) -> Scheme:
    """Decoder-side scheme from unpacked OTI words (nanorq.c:336-376)."""
    if Z == 0:
        Z = Z_MAX
    if N == 0:
        N = 1
    if T < Al or (Al and T % Al != 0) or div_ceil(div_ceil(F, T), Z) > K_MAX:
        raise ValueError(f"invalid OTI: F={F} T={T} Al={Al} Z={Z} N={N}")
    return Scheme(
        F=F, T=T, Al=Al, Z=Z, N=N, Kt=div_ceil(F, T),
        src=Partition.make(div_ceil(F, T), Z),
        sub=Partition.make(T // Al, N),
    )


def symbol_ranges(scheme: Scheme, sbn: int, esi: int, K: int) -> list[tuple[int, int, int]]:
    """Byte ranges of symbol (sbn, esi) in the object, honoring sub-block
    interleaving: list of (byte_offset, length, dest_offset_in_symbol).

    Ranges past F are clipped/skipped (short final symbol zero-padding,
    nanorq.c:148-173).  With N=1 this is a single contiguous range.
    """
    Al = scheme.Al
    units = scheme.T // Al  # symbol size in Al units
    sub = scheme.sub
    # block start in units (get_source_block, nanorq.c:97-112)
    if sbn < scheme.src.JL:
        sbloc = sbn * scheme.src.IL * units
    else:
        sbloc = (scheme.src.IL * scheme.src.JL) * units + (sbn - scheme.src.JL) * scheme.src.IS * units
    part_tot = sub.IL * sub.JL

    out = []
    col = 0
    i = 0
    while i < units:
        if i < part_tot:
            sub_blk = i // sub.IL
            off_units = sbloc + sub_blk * K * sub.IL + esi * sub.IL + i % sub.IL
            sublen = sub.IL
        else:
            i2 = i - part_tot
            sub_blk = i2 // sub.IS
            off_units = sbloc + part_tot * K + sub_blk * K * sub.IS + esi * sub.IS + i2 % sub.IS
            sublen = sub.IS
        i += sublen
        offset = off_units * Al
        stride = sublen * Al
        if offset >= scheme.F:
            col += stride
            continue
        if offset + stride > scheme.F:
            stride = scheme.F - offset
        out.append((offset, stride, col))
        col += sublen * Al
    return out
