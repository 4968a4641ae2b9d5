"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
at its 700 W limit, without sparsity): operations a second by the
dtype a configuration computes in, and HBM bytes a second."""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12, "fp8": 1979e12}
PEAK_BYTES = 3.35e12
