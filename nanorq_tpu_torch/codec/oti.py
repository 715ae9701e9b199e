"""Object Transmission Information (OTI) wire words and packet tags.

Same bit layout as the reference so data.rq streams interoperate:
- common (u64): F << 24 | (T-1) & 0xffff        (nanorq.c:309-315)
- scheme (u32): (Z-1) << 24 | (N-1) << 8 | Al   (nanorq.c:317-324)
- tag (u32):    sbn << 24 | esi                  (nanorq.c:326-330)
T/Z/N are stored decremented to dodge overflow at their type bounds; the
unpack side re-increments (nanorq.c:336-360).
"""


def pack_oti_common(F: int, T: int) -> int:
    return ((F & 0xFFFFFFFFFF) << 24) | ((T - 1) & 0xFFFF)


def unpack_oti_common(common: int) -> tuple[int, int]:
    return common >> 24, (common & 0xFFFF) + 1


def pack_oti_scheme(Z: int, N: int, Al: int) -> int:
    return ((Z - 1) << 24) | ((N - 1) << 8) | (Al & 0xFF)


def unpack_oti_scheme(scheme: int) -> tuple[int, int, int]:
    return ((scheme >> 24) & 0xFF) + 1, ((scheme >> 8) & 0xFFFF) + 1, scheme & 0xFF


def make_tag(sbn: int, esi: int) -> int:
    return ((sbn & 0xFF) << 24) | (esi & 0x00FFFFFF)


def split_tag(tag: int) -> tuple[int, int]:
    return (tag >> 24) & 0xFF, tag & 0x00FFFFFF
