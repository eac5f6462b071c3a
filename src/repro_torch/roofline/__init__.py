"""Roofline terms and FLOP/byte/collective counting for the port."""
