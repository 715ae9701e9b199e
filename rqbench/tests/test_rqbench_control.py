"""The check has to fail what breaks the guarantee: the controls (the plain
reference in the program's place with its sums rounded to bfloat16; a
receiver that recovers nothing) and faults planted under the timed path (a
step that leaves its state unchanged, half of the blocks left out, an
answer altered where it is produced; a receiver's packets made by a sender
that is wrong in a way the receiver cannot see).  Each drives a whole run of
a cell on the CPU at a small size, the chip's look skipped, and sees
`correct` false; the program as it is passes the same run."""

import numpy as np
import pytest

from rqbench import control, harness, traffic

# K=300: the control's rounded sums (up to 8 K bits) pass bfloat16's 256
SMALL = {"K": 300, "T": 16, "Al": 8, "bulk_blocks": 3}
MIXES = ["bulk_enc", "bulk_dec_fixed"]
# the sender's check either way: the reference solves the block, or proves the program's intermediate symbols
SENDER_CHECKS = ["solve", "certificate"]


@pytest.fixture(params=SENDER_CHECKS)
def sender_check(request, monkeypatch):
    if request.param == "certificate":
        monkeypatch.setattr(harness, "SOLVE_MAX_L", 0)
    return request.param


def _run(mix_name, plant=None, seed=2**31 + 17):
    mix = traffic.load(harness.HERE / "traffic" / f"{mix_name}.json")
    cell = harness.Cell(SMALL, dict(mix, warmup=1), seed, "cpu")
    if plant is not None:
        plant(cell)
    cell.make_pool()
    cell.warm_up()
    cell.window(0.2)
    cell.release()
    checks = cell.check()
    return cell.verdict(checks), checks


@pytest.mark.parametrize("mix_name", MIXES)
def test_program_passes(mix_name):
    ok, checks = _run(mix_name)
    assert ok, checks


def test_sender_passes_either_check(sender_check):
    ok, checks = _run("bulk_enc")
    assert ok, checks
    assert ("enc_c_wrong_bytes" in checks) == (sender_check == "certificate")


@pytest.mark.parametrize("mix_name", MIXES)
def test_control_fails(mix_name):
    ok, checks = _run(mix_name, control.install)
    assert not ok
    assert max(v for v, _ in checks.values()) > 0


def test_precode_skipped_control_fails(monkeypatch):
    """The sender's control where the reference does not solve the block."""
    monkeypatch.setattr(harness, "SOLVE_MAX_L", 0)
    ok, checks = _run("bulk_enc", control.install)
    assert not ok and checks["enc_wrong_bytes"][0] > 0 and checks["enc_c_wrong_bytes"][0] == 0


def _sender_fault(kind):
    def plant(cell):
        prog = cell.encode

        def encode(enc, obj, i):
            rows = np.stack([np.asarray(r) for r in prog(enc, obj, i).reshape(cell.Z, cell.n, cell.T)])
            if kind == "unchanged":  # the step hands out its previous answer again
                prev, cell._prev = getattr(cell, "_prev", None), rows
                return rows if prev is None else prev
            if kind == "half":
                rows[cell.Z // 2:] = 0
            else:
                rows[cell.sampler.integers(cell.Z), cell.sampler.integers(cell.n), cell.sampler.integers(cell.T)] ^= 1
            return rows
        cell.encode = encode
    return plant


def _receiver_fault(kind):
    def plant(cell):
        class Faulty(cell.Decoder):
            def repair_block(self, io, sbn):
                b = self._block(sbn)
                if kind == "unchanged" or (kind == "half" and sbn >= self.num_blocks // 2):
                    b.got[:], b.nsrc = True, b.K  # nothing recovered, success reported
                    return True
                gaps = np.nonzero(~b.got)[0]
                ok = super().repair_block(io, sbn)
                if kind == "altered" and gaps.size:
                    io.buffer[(sbn * b.K + int(gaps[0])) * self.symbol_size] ^= 1
                return ok
        cell.Decoder = Faulty
    return plant


def _packet_fault(kind):
    """The pool's sender wrong where the receiver cannot see it: the receiver
    decodes what it is sent all the same."""
    def plant(cell):
        prog = cell.pool_encode

        def pool_encode(obj):
            rep, C = prog(obj)
            if kind == "repair_row":  # a repair packet altered where it is made
                rep[cell.sampler.integers(rep.shape[0]), cell.sampler.integers(cell.T)] ^= 1
            else:  # an intermediate symbol off the RFC's (the packets as made)
                C[cell.sampler.integers(C.shape[0]), cell.sampler.integers(C.shape[1])] ^= 1
            return rep, C
        cell.pool_encode = pool_encode
    return plant


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_sender_faults_fail(kind, sender_check):
    ok, checks = _run("bulk_enc", _sender_fault(kind))
    assert not ok, checks


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_receiver_faults_fail(kind):
    ok, checks = _run("bulk_dec_fixed", _receiver_fault(kind))
    assert not ok, checks


@pytest.mark.parametrize("kind", ["repair_row", "intermediate"])
def test_packet_faults_fail(kind):
    ok, checks = _run("bulk_dec_fixed", _packet_fault(kind))
    assert not ok, checks
    assert checks["packet_wrong_bytes" if kind == "repair_row" else "packet_c_wrong_bytes"][0] > 0
