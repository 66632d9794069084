"""The port's command-line entry points (`python -m repro_torch.launch.<name>`)."""
