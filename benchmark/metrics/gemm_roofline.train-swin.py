"""gemm_roofline.train-swin: the least time at the peaks of the products
that cuBLAS runs (``work/swin_unet.py``: the linears and both attention
products; the convs are cuDNN's) over the device time of the "gemm"
class, percent, in a Swin training cell."""

from benchmark.work.onet import bound_seconds


def read(rec):
    s = rec.get("summary")
    if rec.get("kind") != "train" or not s:
        return None
    t = s["by_class"].get("gemm", 0.0)
    work = [w for w in rec.get("work", ()) if w.get("kind") in
            ("dense", "logits", "values")]
    if not t or not work:
        return None
    return 100.0 * bound_seconds(work, rec["peaks"]) * rec["calls"] / t
