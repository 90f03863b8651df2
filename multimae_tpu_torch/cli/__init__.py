"""Model/loss factory shared by the entry points (cli/factory.py)."""
