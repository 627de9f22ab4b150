"""Auxiliary modules: the environment-knob registry and lock helpers."""
