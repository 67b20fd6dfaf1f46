"""See the package docstring of onedc_tpu_torch."""
