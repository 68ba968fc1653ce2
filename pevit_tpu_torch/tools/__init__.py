"""The port's command-line tools, run with ``python -m
pevit_tpu_torch.tools.<name>``: ``export_model``, ``serve_bench`` and
``quant_agreement``."""
