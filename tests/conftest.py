def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU or interpret "
        "mode); skips where torch.cuda.is_available() is false")
