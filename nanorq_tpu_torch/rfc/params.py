"""RFC 6330 block parameter derivation K -> (K', J, S, H, W, L, P, P1, U, B).

Parity: reference lib/params.c:21-45 (params_init), include/params.h:8-19.
"""

from dataclasses import dataclass

import numpy as np

from nanorq_tpu_torch.rfc.tables import J_K_PADDED, K_PADDED, S_H_W


def _is_prime(n: int) -> bool:
    if n <= 1:
        return False
    if n <= 3:
        return True
    if n % 2 == 0 or n % 3 == 0:
        return False
    i = 5
    while i * i <= n:
        if n % i == 0 or n % (i + 2) == 0:
            return False
        i += 6
    return True


@dataclass(frozen=True)
class Params:
    """Precode parameters for one source block size K (RFC 6330 s5.3.3.3)."""

    K: int  # requested number of source symbols
    Kp: int  # K' >= K, padded to a Table 2 value
    J: int  # systematic index J(K')
    S: int  # number of LDPC symbols
    H: int  # number of HDPC symbols
    W: int  # number of LT symbols
    L: int  # total intermediate symbols = K' + S + H
    P: int  # number of PI symbols = L - W
    P1: int  # smallest prime >= P
    U: int  # P - H
    B: int  # W - S


def params_init(K: int) -> Params:
    """Look up Table 2 for the smallest K' >= K and derive the rest."""
    if K < 1 or K > int(K_PADDED[-1]):
        raise ValueError(f"K={K} out of range [1, {int(K_PADDED[-1])}]")
    i = int(np.searchsorted(K_PADDED, K, side="left"))
    Kp = int(K_PADDED[i])
    J = int(J_K_PADDED[i])
    S, H, W = (int(x) for x in S_H_W[i])
    L = Kp + S + H
    P = L - W
    P1 = P
    while not _is_prime(P1):
        P1 += 1
    return Params(K=K, Kp=Kp, J=J, S=S, H=H, W=W, L=L, P=P, P1=P1, U=P - H, B=W - S)
