"""ops subpackage."""
