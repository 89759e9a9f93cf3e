"""Device ms per train step of the cuBLAS GEMM kernel class, from the profiled steps."""

from harness.layers import class_ms


def read(run):
    return class_ms(run, "train", "GEMM (cuBLAS)")
