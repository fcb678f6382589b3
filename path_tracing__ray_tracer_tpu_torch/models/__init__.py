"""Renderer implementations and the factory registry."""
