SELECT "SearchEngineID", "ClientIP", COUNT(*) AS c, SUM("IsRefresh") AS r,
       AVG("ResolutionWidth") AS a
FROM hits WHERE "SearchPhrase" <> ''
GROUP BY "SearchEngineID", "ClientIP" ORDER BY c DESC LIMIT 10
