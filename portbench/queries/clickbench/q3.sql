SELECT AVG("UserID") AS a FROM hits
