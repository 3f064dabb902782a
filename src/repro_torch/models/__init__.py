"""Models: the dense decoder-only LM (`transformer`) and its building blocks
(`common`)."""
