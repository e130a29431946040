SELECT "RegionID", SUM("AdvEngineID") AS s, COUNT(*) AS c,
       AVG("ResolutionWidth") AS a, COUNT(DISTINCT "UserID") AS u
FROM hits GROUP BY "RegionID" ORDER BY c DESC LIMIT 10
