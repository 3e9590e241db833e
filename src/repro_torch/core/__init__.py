"""Task-kernel plugin registry of the port."""
