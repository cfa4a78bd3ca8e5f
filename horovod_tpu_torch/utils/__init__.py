"""Host-side helpers shared by the recovery layers."""
