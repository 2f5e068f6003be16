"""One module per traffic driver, named by a traffic file's "driver"."""
