from repro_torch.data.synthetic import SyntheticLM  # noqa: F401
