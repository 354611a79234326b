"""Placement schemes of the port (the elementwise family; see `schemes`)."""
