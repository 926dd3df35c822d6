"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W power limit). A configuration's share is taken
against the tensor-core rate of its precision: bf16 runs on the tensor cores
at 989 TFLOP/s; the port computes float32 convs as three TF32 products on
the tensor cores (csrc/conv_mma.cuh), so float32 is held to the TF32 rate,
495 TFLOP/s, the most such a kernel could reach (the CUDA cores' 67 TFLOP/s
would let a sound kernel read over 100 %)."""

FLOPS = {"bf16": 989e12, "f32": 495e12}
BYTES_PER_S = 3.35e12
ITEMSIZE = {"bf16": 2, "f32": 4}


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time of one operation: the larger of its operations over
    the peak rate and its bytes over the memory bandwidth."""
    return max(flops / FLOPS[precision], nbytes / BYTES_PER_S)
