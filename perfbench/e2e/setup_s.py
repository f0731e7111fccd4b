"""setup_s: seconds from process start to the first timed step: CUDA
start, the kernel library's load (its nvcc build on a checkout's first
run), the scene and inputs made from the seed, warm-up."""


def read(m):
    return m["setup_s"]
