"""Host-side input helpers."""
