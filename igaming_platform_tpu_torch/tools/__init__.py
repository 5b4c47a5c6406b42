"""Operator tools of the port: decision replay and drift reference minting."""
