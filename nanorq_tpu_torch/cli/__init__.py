"""Command-line encoder and decoder of the port (`python -m
nanorq_tpu_torch.cli.encode` / `.decode`): the `nanorq_tpu.cli` tools with the
payload math on an explicit `--device`."""
