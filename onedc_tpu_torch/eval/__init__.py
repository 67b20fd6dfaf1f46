"""Evaluation entry points: the inference CLI."""
