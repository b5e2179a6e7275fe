"""Clean fixture: the registry side of kernel-registry-drift; it names
dense_ffn but not ops_bad.py's unregistered_kernel."""


def Kernel(*args, **kwargs):
    return args, kwargs


KERNELS = (Kernel("dense_ffn", "dense_ffn", "csrc/x.cu"),)
