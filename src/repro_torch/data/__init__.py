from repro_torch.data.synthetic import SceneBatch  # noqa: F401
