"""Drivers of a window, one file each, named by a traffic mix."""
