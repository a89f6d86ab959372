from repro_torch.data import scenes  # noqa: F401
