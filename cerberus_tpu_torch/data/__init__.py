"""Host-side numpy data helpers (patch grid, canvas channel map)."""
