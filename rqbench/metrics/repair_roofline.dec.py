"""repair_roofline.dec: the device arm's recovery against the bandwidth
roofline: every block's RFC rows in and out (rqbench.roofline.decode_rows),
whichever plan recovers it (the structured replay of ops.program or the
dense W of ops.wpath), over the union of the kernels launched under
Decoder.repair_block.  Nothing to read where no kernel ran there."""

from rqbench.readers import kernel_s
from rqbench.roofline import decode_rows, share_pct


def read(run):
    secs = kernel_s(run, "repair")
    if secs <= 0:
        return None
    rows = sum(sum(decode_rows(run.K, lost, run.overhead)) for o in run.objects for lost in o.get("lost", ()))
    return share_pct(rows * run.T, secs)
