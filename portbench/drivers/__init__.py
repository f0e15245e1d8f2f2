"""Drivers of the traffic mixes, one file a driver (``traffic/<mix>.json`` names it)."""
