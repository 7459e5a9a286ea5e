"""Device milliseconds of the dense layers' matrix products a unit (a
step or a request): every kernel, copy or memset launched inside one of
PyTorch's matrix-product operators (`tracing.PRODUCT_OPS`), whatever the
kernel is named, so that a product that moves to a gemv, a split-K
reduction or another library's kernel stays counted.  The operators'
FLOPs, from their input shapes, must cover the model's dense FLOPs
(`yardstick.unit_work`: each product of the forward, and for training
the backward's two): a product run outside such an operator would leave
the metric unseen, so the run fails instead."""


def read(w):
    flops, seconds, ops = w.product_time()
    want = w.units * w.work.dense_flops
    if ops == 0 and want == 0:
        return None
    if flops < want * (1 - 1e-9) or seconds <= 0:
        raise RuntimeError(
            f"matrix products: {ops} operators of {flops:.6g} FLOPs and "
            f"{seconds:.6g} s on the device in the trace, the model's "
            f"dense products {want:.6g} FLOPs")
    return 1e3 * seconds / w.units
