"""One driver a kind of traffic; a traffic file names its driver."""
