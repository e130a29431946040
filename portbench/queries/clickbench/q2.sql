SELECT SUM("AdvEngineID") AS s, COUNT(*) AS c, AVG("ResolutionWidth") AS a FROM hits
