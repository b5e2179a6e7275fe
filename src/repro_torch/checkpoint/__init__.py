"""The reference's checkpoint layout: reader and writer (numpy and json only)."""
