"""The exact CPU sweep (the confirmation oracle)."""
