"""Model families and the registry the server builds from."""
