from repro_torch.serve.engine import Engine, ServeConfig, ServeStats  # noqa: F401
