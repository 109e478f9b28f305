"""Shared utilities: native-library loading."""
