"""Whole-slide helpers: readers, placement, boundary dedup, disk canvas."""
