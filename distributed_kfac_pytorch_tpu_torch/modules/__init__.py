"""Building-block modules of the port."""
