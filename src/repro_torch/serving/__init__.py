"""Continuous-batching serving engine and sampling."""
