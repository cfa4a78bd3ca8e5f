"""The package version (the project's, ``pyproject.toml``)."""

__version__ = "0.5.0"
