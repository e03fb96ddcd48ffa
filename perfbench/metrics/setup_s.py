"""setup_s: process start to window start (CUDA init, loading the kernel
library, drawing the weights on the device, drawing and quantizing the
fleet, warm-up at the cell's shapes, and the traffic's ramp)."""


def read(out):
    return out.setup_s
