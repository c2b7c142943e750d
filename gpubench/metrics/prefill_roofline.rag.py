"""The prefill kernels: #3's tensor-core route (9 to 256 rows), #6 (rows
kernel) and #5 (causal prefill attention).  Each call's least time from its
shapes (``counts``) summed, over the device time of the operations launched
inside their wrappers (``kernel.fused_tc``, ``kernel.rows``,
``kernel.prefill_attention``), where every launch of the tensor-core W8A16
kernel and of #5 by name has to lie."""
from gpubench import counts
from gpubench.readers import span_roofline


def read(run):
    peak = run.peak

    def matrix(call):
        nbytes, ops = counts.rows_cols_counts(call["rows"], call["n"], call["d"], call["g"])
        return counts.least_seconds(nbytes, ops, peak)

    def attention(call):
        nbytes, ops = counts.prefill_attention_counts(call["b"], call["s"], call["h"], call["kv"], call["hd"])
        return counts.least_seconds(nbytes, ops, peak)

    return span_roofline(run, {"kernel.fused_tc": matrix, "kernel.rows": matrix, "kernel.prefill_attention": attention},
                         ("w8a16_tc_kernel", "prefill_attention_kernel"))
