"""Paper experiment configurations."""
