SELECT MIN("EventDate") AS mn, MAX("EventDate") AS mx FROM hits
