"""#11, the whole-step decode kernel: its least bytes at each launch's live
rows and positions (``counts.megakernel_bytes``, the classifier's logits at
the real vocabulary) at the memory's rate, summed, over the device time of
the operations launched inside its wrapper (``kernel.megakernel``), where
every launch of the kernel by name has to lie."""
from gpubench import counts
from gpubench.readers import span_roofline


def read(run):
    c = run.cell.shapes

    def bound(call):
        if call["positions"] is None:
            return None
        pos = call["positions"]
        return counts.megakernel_bytes(c, pos, 2, written=len(pos), v_pad=c.vocab_size) / run.peak["hbm_bytes_per_s"]

    return span_roofline(run, {"kernel.megakernel": bound}, ("decode_megakernel",))
