"""Operation schedule: the solved elimination program for one precode system.

The solver (precode/solver.py) runs Gaussian elimination with inactivation
over matrix *indices* only and records a linear program of GF(256) row
operations; the replayer applies that program to the payload matrix D.  This
is the reference's schedule/payload split (lib/sched.c, lib/precode.c:23-32)
re-designed for TPU replay:

- ops are already *linearized* into final execution order (the reference's
  4-segment fwd/rev/fwd/fwd replay order is flattened at solve time), so the
  replayer is a single scan;
- every op has uniform semantics  D[i] = alpha (x) D[i]  ^  beta (x) D[j],
  so the device kernel is branchless (scal ops encode beta=0);
- the final row/column permutation is a single gather vector:
  C = D_final[gather].
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Schedule:
    """Linearized elimination program for one (K', received-ISI) system."""

    L: int  # number of intermediate symbols / columns
    n_rows: int  # rows of D touched by the program (= L + overhead)
    i: int  # triangularized prefix size (diagnostic)
    u: int  # inactivated column count (diagnostic)
    op_i: np.ndarray  # int32 [n_ops] destination row
    op_j: np.ndarray  # int32 [n_ops] source row
    op_alpha: np.ndarray  # uint8 [n_ops] scale applied to D[i] (1 = keep)
    op_beta: np.ndarray  # uint8 [n_ops] scale applied to D[j] (0 = pure scal)
    gather: np.ndarray  # int32 [L]: C[v] = D_final[gather[v]]
    # segment lengths (s1a, s1b, dense, backsolve) of the underlying recorded
    # program; the linearized stream is s1a|s1b|dense|rev(s1a)|back|s1a
    seg_lens: tuple[int, int, int, int] = (0, 0, 0, 0)

    @property
    def n_ops(self) -> int:
        return int(self.op_i.shape[0])

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            meta=np.array([self.L, self.n_rows, self.i, self.u], np.int64),
            op_i=self.op_i,
            op_j=self.op_j,
            op_alpha=self.op_alpha,
            op_beta=self.op_beta,
            gather=self.gather,
        )

    @staticmethod
    def load(path: str) -> "Schedule":
        z = np.load(path)
        L, n_rows, i, u = (int(x) for x in z["meta"])
        return Schedule(
            L=L,
            n_rows=n_rows,
            i=i,
            u=u,
            op_i=z["op_i"],
            op_j=z["op_j"],
            op_alpha=z["op_alpha"],
            op_beta=z["op_beta"],
            gather=z["gather"],
        )


def replay_numpy(D: np.ndarray, S: Schedule) -> np.ndarray:
    """Apply the program to payload matrix D (rows >= S.n_rows) on the host.

    Returns C [L, T].  Reference analog: precode_matrix_intermediate
    (lib/precode.c:379-389).  This is the slow correctness oracle; the
    production path is nanorq_tpu_torch.ops.replay on device.
    """
    from nanorq_tpu_torch.gf256.tables import GF_MUL

    D = D.copy()
    oi, oj, oa, ob = S.op_i, S.op_j, S.op_alpha, S.op_beta
    for k in range(S.n_ops):
        i, j, a, b = int(oi[k]), int(oj[k]), int(oa[k]), int(ob[k])
        if a == 1:
            if b == 1:
                D[i] ^= D[j]
            elif b:
                D[i] ^= GF_MUL[b, D[j]]
        else:
            if b == 0:
                D[i] = GF_MUL[a, D[i]]
            else:  # not emitted by the solver, but keep semantics total
                D[i] = GF_MUL[a, D[i]] ^ GF_MUL[b, D[j]]
    return D[S.gather]
