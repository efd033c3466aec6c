"""Data-parallel helpers of the port: gradient compression."""
