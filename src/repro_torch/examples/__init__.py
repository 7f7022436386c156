"""Runnable examples (twins of the reference's ``examples/``)."""
