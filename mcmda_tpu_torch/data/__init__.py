"""Host-side volume IO, benchmark constants and synthetic phantoms (numpy)."""
