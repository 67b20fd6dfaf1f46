"""Evaluation entry points: the inference CLI, the quality harness and the
RD sweep."""
