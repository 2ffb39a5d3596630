"""Configuration dataclasses."""
